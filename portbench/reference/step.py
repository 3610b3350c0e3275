"""The plain reference of the optimisation step, followed from the seed.

``follow`` starts where the program starts (the same seed, the same
weights, the drawer's initial latent drawn again) and runs ``steps`` plain
float32 steps with TF32 off: render, pool per tower, cutouts, tower,
spherical prompt loss, the gradient by autograd, Adam, the drawer's clamp.
It returns each step's loss, the first step's gradient and the latent after
the last step, and the first step's gradient once more with the towers'
range stretch taken as constant (``grad0_rest``): the bank's min and max
gather the gradient of every bank element onto the few elements that tie
for them, which rounding moves.  It reads the program's inputs (seed,
weights, settings) and none of its outputs.
"""

from __future__ import annotations

import importlib
import math

import torch

from portbench.reference import cutouts as RC
from portbench.reference.clip import CLIP, byte_tokens

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def spherical_dist(x, y):
    x, y = torch.nn.functional.normalize(x, dim=-1), torch.nn.functional.normalize(y, dim=-1)
    return 2.0 * torch.arcsin(torch.linalg.vector_norm(x - y, dim=-1) / 2.0) ** 2


def prompt_rows(settings: dict, model: CLIP, device):
    """[(embedding (D,), weight)] of a tower's text prompts."""
    rows = []
    for prompt in settings["prompts"]:
        text, weight = prompt, 1.0
        if ":" in prompt:
            text, w = prompt.rsplit(":", 1)
            weight = float(w)
        d = model.dims
        tokens = torch.tensor([byte_tokens(text, d["context_length"], d["vocab_size"])], device=device)
        rows.append((model.encode_text(tokens)[0], float(weight)))
    return rows


def render(settings: dict, weights: dict, z, device):
    """The drawer's (H, W, 3) float32 canvas of the latent ``z``."""
    drawer = importlib.import_module(f"portbench.reference.drawers.{settings['drawer']}").Drawer(
        settings, weights.get(settings["drawer"]), torch.device(device))
    with torch.no_grad():
        return drawer.synth(z.to(device))


def follow(settings: dict, weights: dict, seed: int, device, steps: int):
    """``settings``: the reference's view of a cell (``harness.cell.reference_settings``);
    ``weights``: {model name: state dict}.  Returns {"losses": [float],
    "grad0": the first step's gradient, "grad0_rest": it without the range
    stretch's gradient, "z0", "z1", "z": the latents before the first step,
    after it and after the last}."""
    device = torch.device(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(settings, weights, seed, device, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _follow(settings, weights, seed, device, steps):
    int_seed = seed % 2 ** 30
    gen = torch.Generator().manual_seed(int_seed)
    gen_device = torch.Generator(device=device).manual_seed(int_seed)
    drawer = importlib.import_module(f"portbench.reference.drawers.{settings['drawer']}").Drawer(
        settings, weights.get(settings["drawer"]), device)
    z = drawer.init(gen, seed).to(device)
    z0 = z.clone()

    towers, tables = [], []
    for name in settings["clip_models"]:
        model = CLIP(settings["towers"][name]).to(device)
        model.load_state_dict(weights[name])
        model.requires_grad_(False)
        with torch.no_grad():
            rows = prompt_rows(settings, model, device)
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
