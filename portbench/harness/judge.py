"""The comparison that decides ``correct``.

The program's first steps (``drive.ProgramRun``) against the plain
reference followed from the same seed and weights; each number a relative
gap against the reference:

- ``loss_gap``: the largest |loss_program - loss_reference| / |loss_reference|
  over the steps followed; ``loss0_gap``: the same of step 0 alone;
- ``grad0_gap``: the gap of the L1 norms (| |g_p|_1 - |g_r|_1 | / |g_r|_1)
  of the first step's gradient (the program's from Adam's first moment
  after step 0); ``grad0_median_gap``: the gap of the medians of |g|;
- ``grad0_rest_gap``: the gap of the first gradient's components along u,
  the direction of the reference's first gradient with the towers' range
  stretch taken as constant (| <g_p, u> - <g_r, u> | / | <g_r, u> |): the
  gradient that the stretch gathers onto the bank's tied extremes, which
  rounding moves, is nearly orthogonal to u, and what the towers and the
  bank give every other element lies along it;
- ``change_gap``: the gap of the L2 norms of the latent's change over the
  steps followed (a step that leaves the latent unchanged reads 1);
- ``image_gap``: |image_p - image_r|_2 / |image_r|_2 of step 0's checkin
  render, the reference rendering the program's own latent after step 0.

Where the reference starts from the program's initial latent (``"start":
"program"``), the init is checked by itself, on the program's own init
image:

- ``init_gap``: |pre_p - pre_r|_2 / |pre_r|_2 of the encoder's output
  before quantization, the program's against the plain float32 encoder's;
- ``init_quant_gap``: |z0_p - q_r(pre_p)|_2 / |q_r(pre_p)|_2, the
  program's initial latent against the plain nearest codes of the
  program's own ``pre_p``: a latent that is not the quantized encoding
  reads about sqrt(2);
- ``init_code_share`` (reported, not compared): the share of tokens whose
  code in the program's initial latent is not the plain encoder's; a
  lower precision's encoding changes the nearest code of many tokens.

The latent is one leaf in every configuration here, so "the worst leaf" is
that leaf.  A cell compares the numbers its ``workloads/<cell>.json``
gives a limit; a number that is not finite fails.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("loss_gap", "loss0_gap", "grad0_gap", "grad0_median_gap", "grad0_rest_gap", "change_gap", "image_gap",
           "init_gap", "init_quant_gap")
REPORTED = ("init_code_share",)  # reported beside the compared numbers, never compared


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double().reshape(-1)))


def _gap(p: float, r: float) -> float:
    return abs(p - r) / abs(r)


def numbers(prog, ref: dict) -> dict:
    lp, lr = prog.losses, ref["losses"]
    if len(lp) != len(lr):
        raise ValueError(f"{len(lp)} program losses against {len(lr)} reference losses")
    dev = ref["z"].device
    gp, gr = prog.grad0.to(dev).double(), ref["grad0"].double()
    u = ref["grad0_rest"].double().reshape(-1)
    u = u / torch.linalg.vector_norm(u)
    out = {"loss_gap": max(_gap(a, b) for a, b in zip(lp, lr)), "loss0_gap": _gap(lp[0], lr[0]),
           "grad0_gap": _gap(float(gp.abs().sum()), float(gr.abs().sum())),
           "grad0_median_gap": _gap(float(gp.abs().median()), float(gr.abs().median())),
           "grad0_rest_gap": _gap(float(gp.reshape(-1) @ u), float(gr.reshape(-1) @ u)),
           "change_gap": _gap(_norm(prog.z_block.to(dev) - prog.z0.to(dev)), _norm(ref["z"] - ref["z0"]))}
    if "image" in ref and prog.image1 is not None:
        out["image_gap"] = _norm(prog.image1.to(dev) - ref["image"]) / _norm(ref["image"])
    if "init_pre" in ref:
        nan = float("nan")
        pre, z0 = ref["init_pre"], prog.z0.to(dev)
        out["init_gap"] = nan if prog.init_pre is None else _norm(prog.init_pre.to(dev) - pre) / _norm(pre)
        q = ref["init_quant"]
        out["init_quant_gap"] = nan if q is None else _norm(z0 - q) / _norm(q)
        out["init_code_share"] = ref["init_code_share"]
    return out


def verdict(nums: dict, limits: dict) -> tuple[bool, list[str]]:
    """(correct, one line per reported number, then one per compared
    number: its name, value and limit)."""
    lines, ok = [f"{name} {nums[name]!r} not compared" for name in REPORTED if name in nums], True
    for name in (n for n in NUMBERS if n in limits):
        v, lim = nums.get(name, float("nan")), float(limits[name])
        good = math.isfinite(v) and v <= lim
        ok = ok and good
        lines.append(f"{name} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}")
    return ok, lines
