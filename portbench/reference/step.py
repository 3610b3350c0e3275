"""The plain reference of the optimisation step, followed from the seed.

``follow`` starts where the program starts (the same seed, the same
weights, the drawer's initial latent drawn again, or the program's own
initial latent where the cell says ``"start": "program"``; then
``init_check`` works out the init's encoding again) and runs ``steps`` plain
float32 steps with TF32 off: render, pool per tower, cutouts, tower,
spherical prompt loss, the gradient by autograd, Adam, the drawer's clamp.
It returns each step's loss, the first step's gradient and the latent after
the last step, and the first step's gradient once more with the towers'
range stretch taken as constant (``grad0_rest``): the bank's min and max
gather the gradient of every bank element onto the few elements that tie
for them, which rounding moves.  It reads the program's inputs (seed,
weights, settings, the init image and the vector prompts' files) and, but
for that initial latent, none of its outputs.

The prompt rows are the text prompts' embeddings and the vector prompts'
stored ones (``vectors/<name>.json``, found where the program looks,
0.1 times the prompt's weight, each tower its own row), as pixray builds
its prompt table.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os

import torch

from portbench.reference import cutouts as RC
from portbench.reference.clip import CLIP, byte_tokens

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def spherical_dist(x, y):
    x, y = torch.nn.functional.normalize(x, dim=-1), torch.nn.functional.normalize(y, dim=-1)
    return 2.0 * torch.arcsin(torch.linalg.vector_norm(x - y, dim=-1) / 2.0) ** 2


def parse_prompt(prompt: str):
    """(text, weight, stop) of ``text[:weight]`` or ``text:stop:weight``, as pixray parses a prompt."""
    numbers = []
    while len(numbers) < 2:
        parts = prompt.rsplit(":", 1)
        try:
            numbers.append(float(parts[1]))
        except (IndexError, ValueError):
            break
        prompt = parts[0]
    weight = numbers[-1] if numbers else 1.0
    stop = numbers[0] if len(numbers) == 2 else float("-inf")
    return prompt, weight, stop


def vector_file(name: str, root: str):
    """The vector prompt's file, where the program looks for it: a name
    holding ``json`` is a path; else ``<name>.json`` under
    ``$PIXRAY_TPU_VECTORS``, ``vectors/`` or the checkout's ``vectors/``."""
    if "json" in name:
        return name if os.path.exists(name) else None
    for base in (os.environ.get("PIXRAY_TPU_VECTORS", ""), "vectors", os.path.join(root, "vectors")):
        if base and os.path.exists(os.path.join(base, f"{name}.json")):
            return os.path.join(base, f"{name}.json")
    return None


def vector_rows(settings: dict, tower: str, device):
    """[(embedding (D,), weight)] of the vector prompts for the tower named
    ``tower``: each stored row at 0.1 times the prompt's weight; a file or
    a tower it lacks gives no row."""
    rows = []
    for prompt in settings.get("vector_prompts", []):
        name, weight, stop = parse_prompt(prompt)
        if stop != float("-inf"):
            raise NotImplementedError("the reference has no prompt stops")
        path = vector_file(name, settings["root"])
        if path is None:
            continue
        with open(path) as f:
            table = json.load(f)
        if tower in table:
            embeds = torch.atleast_2d(torch.tensor(table[tower], dtype=torch.float32, device=device))
            rows.extend((e, 0.1 * weight) for e in embeds)
    return rows


def prompt_rows(settings: dict, model: CLIP, device, tower: str = ""):
    """[(embedding (D,), weight)] of a tower's text prompts, then its vector prompts."""
    rows = []
    for prompt in settings["prompts"]:
        text, weight = prompt, 1.0
        if ":" in prompt:
            text, w = prompt.rsplit(":", 1)
            weight = float(w)
        d = model.dims
        tokens = torch.tensor([byte_tokens(text, d["context_length"], d["vocab_size"])], device=device)
        rows.append((model.encode_text(tokens)[0], float(weight)))
    return rows + vector_rows(settings, tower, device)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off in matmuls and convolutions."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _drawer(settings: dict, weights: dict, device):
    return importlib.import_module(f"portbench.reference.drawers.{settings['drawer']}").Drawer(
        settings, weights.get(settings["drawer"]), torch.device(device))


def init_check(settings: dict, weights: dict, image, pre, z0, device) -> dict:
    """The init's encoding worked out again, for a cell whose reference
    starts from the program's latent ``z0``: {"init_pre": the encoder's
    output before quantization on the program's init ``image``,
    "init_quant": the latent of the nearest codes of the program's own
    output before quantization ``pre`` (None without it), "init_code_share":
    the share of tokens whose code in ``z0`` is not the nearest to
    "init_pre" (None without ``z0``), "init_latent": the latent of those
    nearest codes}."""
    drawer = _drawer(settings, weights, device)
    with no_tf32():
        ref_pre = drawer.encode(image.to(device))
        latent = drawer.quantize(ref_pre)
        share = None if z0 is None else float((drawer.codes(z0.to(device)) != drawer.codes(latent)).double().mean())
        return {"init_pre": ref_pre, "init_latent": latent, "init_code_share": share,
                "init_quant": None if pre is None else drawer.quantize(pre.to(device).float())}


def render(settings: dict, weights: dict, z, device):
    """The drawer's (H, W, 3) float32 canvas of the latent ``z``."""
    drawer = _drawer(settings, weights, device)
    with torch.no_grad():
        return drawer.synth(z.to(device))


def follow(settings: dict, weights: dict, seed: int, device, steps: int, z0=None):
    """``settings``: the reference's view of a cell (``harness.cell.reference_settings``);
    ``weights``: {model name: state dict}; ``z0``: the initial latent, or
    None to draw the drawer's again from the seed (the program's own
    initial latent takes no draw of the cut generators: the init noise
    draws from a generator of its own).  Returns {"losses": [float],
    "grad0": the first step's gradient, "grad0_rest": it without the range
    stretch's gradient, "z0", "z1", "z": the latents before the first step,
    after it and after the last}."""
    device = torch.device(device)
    with no_tf32():
        return _follow(settings, weights, seed, device, steps, z0)


def _follow(settings, weights, seed, device, steps, z0):
    int_seed = seed % 2 ** 30
    gen = torch.Generator().manual_seed(int_seed)
    gen_device = torch.Generator(device=device).manual_seed(int_seed)
    drawer = _drawer(settings, weights, device)
    z = (drawer.init(gen, seed) if z0 is None else z0).to(device).clone()
    z0 = z.clone()

    towers, tables = [], []
    for name in settings["clip_models"]:
        model = CLIP(settings["towers"][name], settings.get("bench_dir")).to(device)
        model.load_state_dict(weights[name])
        model.requires_grad_(False)
        with torch.no_grad():
            rows = prompt_rows(settings, model, device, name)
        towers.append(model)
        tables.append(rows)
    cuts = [settings["towers"][n]["image_resolution"] for n in settings["clip_models"]]
    noise_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    aspect = settings["size"][0] / settings["size"][1]

    def loss_and_grad(it, fill, draws, range_grad=True):
        zp = z.detach().requires_grad_(True)
        img = drawer.synth(zp)
        total = torch.zeros((), device=device)
        for model, rows, cut, d in zip(towers, tables, cuts, draws):
            bank = RC.bank(RC.pool_to_work(img, cut), d, fill, cut, reflect=it % 2 == 0)
            emb = model.encode_image(bank, range_grad)
            for embed, weight in rows:
                total = total + abs(weight) * (spherical_dist(emb, embed[None]) * math.copysign(1.0, weight)).mean()
        (g,) = torch.autograd.grad(total, zp)
        return float(total.detach()), g.detach()

    m, v = torch.zeros_like(z), torch.zeros_like(z)
    losses, grad0, grad0_rest = [], None, None
    for it in range(steps):
        fill, draws = RC.draw_step(gen, gen_device, cuts, settings["num_cuts"], aspect, noise_dtype, device)
        loss, g = loss_and_grad(it, fill, draws)
        losses.append(loss)
        if grad0 is None:
            grad0 = g.clone()
            grad0_rest = loss_and_grad(it, fill, draws, range_grad=False)[1]
        with torch.no_grad():
            m = (1 - ADAM_B1) * g + ADAM_B1 * m
            v = (1 - ADAM_B2) * g * g + ADAM_B2 * v
            # optax's Adam in float32: the bias corrections and the rate as float32 numbers
            count = torch.tensor(float(it + 1), device=device)
            c1, c2 = 1 - torch.pow(ADAM_B1, count), 1 - torch.pow(ADAM_B2, count)
            lr = torch.tensor(drawer.lr, dtype=torch.float32, device=device)
            z = drawer.clip(z + (-lr * ((m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))))
        if it == 0:
            z1 = z.clone()
    return {"losses": losses, "grad0": grad0, "grad0_rest": grad0_rest, "z0": z0, "z1": z1, "z": z.detach()}
