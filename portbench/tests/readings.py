"""The readings that a cell's limits are set from, on the card, in one process.

    python portbench/tests/readings.py --workload <cell> --seed <first> \
        --sound 12 --control 3 --faults 3

For each seed from ``--seed`` on: the program as the configuration states
it (``sound``), the control (the program with its own int8 rungs switched
on: int8 towers with int8 input gradients, the int8 warp forward and
backward), and the planted faults (``unchanged``: every step returns the
latent and the optimizer state as they were; ``half``: each tower sees the
first half of its cutouts and the loss is the mean over those), each
followed by the reference as a run follows it.  ``--variants`` adds more,
each on ``--control`` seeds: ``fp8`` (the reference in the program's
place with its VQGAN's convolutions in float8 e4m3: the encoder's, for a
cell that starts from the program's latent, and the decoder's) and the
fault ``init_unencoded`` (the VQGAN drawer encodes its init image and
takes its latent from random codes).  No window is measured.  Prints one
JSON line per run with the compared numbers and each step's loss gap.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

CONTROL_RUNGS = {"PIXRAY_TPU_CLIP_PREC": "int8b", "PIXRAY_TPU_WARP_PREC": "int8", "PIXRAY_TPU_WARP_BWD_PREC": "int8"}


@contextlib.contextmanager
def environment(values: dict):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def unchanged_steps():
    """Every step computes its loss and gradient and keeps the latent and
    the optimizer state as they were."""
    from pixray_tpu_torch.engine import core, step
    from pixray_tpu_torch.engine.latent import tree_map

    orig = step.train_step

    def kept(cfg, optimizer, z, opt_state, lr_scale, inputs):
        return orig(cfg, optimizer, tree_map(lambda t: t.clone(), z), optimizer.clone(opt_state), lr_scale, inputs)

    step.train_step = core.train_step = kept
    try:
        yield
    finally:
        step.train_step = core.train_step = orig


@contextlib.contextmanager
def init_unencoded():
    """The VQGAN drawer encodes its init image, then takes its latent from
    random codes, drawn from a generator of their own so that the cut
    draws stay in step."""
    from pixray_tpu_torch.drawers.vqgan import VqganDrawer

    orig = VqganDrawer.init_params

    def unencoded(self, gen, init_tensor=None, indices=None):
        z = orig(self, gen, init_tensor, indices)
        n = self.model.quantize.codebook.shape[0]
        codes = torch.randint(0, n, (z.shape[0] * z.shape[1],), generator=torch.Generator().manual_seed(0))
        return orig(self, gen, None, codes)

    VqganDrawer.init_params = unencoded
    try:
        yield
    finally:
        VqganDrawer.init_params = orig


@contextlib.contextmanager
def half_batch():
    """Each tower embeds only the first half of its cutouts."""
    from pixray_tpu_torch.models.perceptor import Perceptor

    orig = Perceptor.image_fn

    def half(self, imgs, affine=None):
        return orig(self, imgs[: imgs.shape[0] // 2], affine)

    Perceptor.image_fn = half
    try:
        yield
    finally:
        Perceptor.image_fn = orig


def diagnostics(prog, ref) -> dict:
    """What the gradient's and the change's norms are made of: the gaps of
    their L1 and L2 norms, the share of the squared L2 norm in the 16
    largest elements, and the cosine of program and reference."""
    out = {}
    dev = ref["z"].device
    pairs = {"grad0": (prog.grad0.to(dev), ref["grad0"]),
             "change": (prog.z_block.to(dev) - prog.z0.to(dev), ref["z"] - ref["z0"])}
    for name, (p, r) in pairs.items():
        p, r = p.double().reshape(-1), r.double().reshape(-1)
        l1p, l1r = float(p.abs().sum()), float(r.abs().sum())
        out[f"{name}_l1_gap"] = abs(l1p - l1r) / l1r
        out[f"{name}_l2_gap"] = abs(float(p.norm()) - float(r.norm())) / float(r.norm())
        for side, t in (("prog", p), ("ref", r)):
            sq = t.square()
            out[f"{name}_top16_share_{side}"] = float(sq.topk(min(16, sq.numel())).values.sum() / sq.sum())
        out[f"{name}_cos"] = float(torch.nn.functional.cosine_similarity(p, r, dim=0))
    return out


def fp8_round(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at e4m3's largest, 448)."""
    s = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class Fp8(torch.autograd.Function):
    """Rounds to float8 e4m3 forward, and the cotangent backward."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


@contextlib.contextmanager
def fp8_vqgan():
    """The reference's VQGAN encoder and decoder with every convolution's
    input, weight, output and cotangents rounded to float8 e4m3."""
    from portbench.reference import vqgan as RV

    inside = {"on": False}
    conv_forward, enc_forward, dec_forward = torch.nn.Conv2d.forward, RV.Encoder.forward, RV.Decoder.forward

    def conv(self, x):
        if not inside["on"]:
            return conv_forward(self, x)
        return Fp8.apply(self._conv_forward(Fp8.apply(x), fp8_round(self.weight), self.bias))

    def inside_of(forward):
        def run(self, x):
            inside["on"] = True
            try:
                return forward(self, x)
            finally:
                inside["on"] = False
        return run

    torch.nn.Conv2d.forward, RV.Encoder.forward, RV.Decoder.forward = conv, inside_of(enc_forward), inside_of(dec_forward)
    try:
        yield
    finally:
        torch.nn.Conv2d.forward, RV.Encoder.forward, RV.Decoder.forward = conv_forward, enc_forward, dec_forward


VARIANTS = {"sound": contextlib.nullcontext, "control": lambda: environment(CONTROL_RUNGS),
            "unchanged": unchanged_steps, "half": half_batch, "init_unencoded": init_unencoded}
REFERENCE_CONTROLS = {"fp8": fp8_vqgan}


def reading(cell, seed: int, variant: str, device) -> dict:
    from portbench.harness import cell as C
    from portbench.harness import drive, judge
    from portbench.harness import measure as M
    from portbench.harness import weights as W
    from portbench.reference import step as R

    t0 = time.perf_counter()
    settings = C.reference_settings(cell)
    from_program = C.start(cell) == "program"
    if variant in REFERENCE_CONTROLS:  # the reference in the program's place, one precision lower
        steps = 1 + int(cell.traffic["program"].get("steps_per_call", 0) or 8)
        image = z0 = pre = None
        if from_program:  # the program's init image, from a sound build
            sound = drive.run(cell, seed, 0.0, False, device, t0)
            drive.release(sound)
            image = sound.init_image
        with REFERENCE_CONTROLS[variant]():
            low_weights = W.make(settings, seed, device)
            if from_program:
                init = R.init_check(settings, low_weights, image, None, None, device)
                pre, z0 = init["init_pre"], init["init_latent"]
            low = R.follow(settings, low_weights, seed, device, steps, z0=z0)
            image1 = R.render(settings, low_weights, low["z1"], device).cpu()
        prog = drive.ProgramRun(losses=low["losses"], grad0=low["grad0"], z0=low["z0"], z_block=low["z"],
                                followed_steps=steps, z1=low["z1"], image1=image1, init_image=image, init_pre=pre)
        del low_weights
    else:
        with VARIANTS[variant]():
            prog = drive.run(cell, seed, 0.0, False, device, t0)
        drive.release(prog)
    weights = W.make(settings, seed, device)
    ref = M.reference(cell, settings, weights, seed, device, prog)
    del weights
    nums = judge.numbers(prog, ref)
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog.losses, ref["losses"])]
    look = diagnostics(prog, ref)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"cell": cell.name, "variant": variant, "seed": seed, **nums, "step_loss_gaps": gaps,
            "losses": prog.losses, "ref_losses": ref["losses"], **look, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--sound", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--variants", default="", help="comma-separated extra variants, each on --control seeds")
    p.add_argument("--set", action="append", default=[], help="key=json: a program setting over the cell's traffic")
    args = p.parse_args(argv)

    from portbench.harness import cell as C

    cell = C.load(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        cell.traffic["program"][key] = json.loads(value)
    plan = ([("sound", k) for k in range(args.sound)] + [("control", k) for k in range(args.control)]
            + [(f, k) for f in ("unchanged", "half") for k in range(args.faults)]
            + [(v, k) for v in args.variants.split(",") if v for k in range(args.control)])
    for variant, k in plan:
        print(json.dumps(reading(cell, args.seed + k, variant, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
