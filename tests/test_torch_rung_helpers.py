"""The plain helpers the redesigned K1-int8 and K2-bf16 kernels rest on,
on the CPU (``ops/warp_batch.py``):

- ``pack_texels(quantize_canvas(work)[0])``, the plain twin of K1-int8's
  pack pass (the canvas quantized and packed as one 32-bit texel per
  canvas pixel), holds the codes of the kernel's operations in its order
  (a true division by s_w, the product with 127, round half to even; here
  in numpy float32) in bytes 0-2 and zero in byte 3: on canvases holding
  +s_w and -s_w and values whose quotient times 127 is an exact half
  (where round-half-even decides), and on the tie-rich canvas of
  ``chip_smoke.py`` phase 3b;
- ``tap_row_ranges``, the plain twin of K2-bf16's row table (per cut and
  output row, the least and the greatest canvas row that a tap on the
  canvas reads), equals a brute force over every pixel's taps from
  ``_rung_taps`` (the taps K2's rung variants read), on axis-aligned,
  perspective, reflection, border, zeros and fill cuts: the ragged
  tie-rich bank of phase 3b (9 cuts of 40 on 90x100, zoomed out past the
  canvas) and 8 cuts of 384 on 384x384 drawn as the flagship bank's;
- ``cuda_warp.bank_cotangent_plain``, the plain twin of K2-int8's
  cotangent pass (the post-epilogue cotangent bank in the bank's dtype and
  its s_g), against autograd through the bank's plain epilogue
  (``bank_epilogue_plain``): in f32 within 1e-5 of the largest cotangent
  (the explicit adjoint sums autograd's terms in another order, as
  test_torch_cutout_bank.py holds ``jitter_planes_adjoint``), in bf16
  within one bf16 ulp (2**-8 relative) plus 4e-5 of the largest cotangent
  (that f32 difference can round to the neighbouring bf16 value, and
  terms that cancel leave it beside a small result, as chip_smoke.py's
  ADJOINT_ULP and ADJOINT_CANCEL); the cuts without jitter, and every cut
  without a saved bank, keep g bitwise; s_g is max|cotangent| clamped at
  1e-20.  (Its maximum against the JAX int8 backward's scale is in
  test_torch_warp_rungs.py.)
- ``pack_bf16_texels``, the plain twin of K1-bf16's and K1-high's pack
  pass, holds in its planes, bit for bit, the splits of the JAX package's
  ``_mm`` (``pixray_tpu/ops/pallas_warp.py``): ``a.astype(bfloat16)`` and
  ``(a - a_hi).astype(bfloat16)``, on seeded canvases with ties, negatives,
  signed zeros and values at bf16 rounding boundaries (exact halves between
  two bf16 values, with even and odd last bits, and their neighbours);
  their sum equals ``_mm`` itself against an identity;
- a plain warp from those texels, as the redesigned kernels form it (one
  texel a tap, the y hats split once, each column a sum of two bf16
  products, which are exact in f32), equals ``warp_modes_rung(...,
  "bf16" / "high")`` bitwise on the ragged tie-rich bank and on a
  perspective bank in every mode;
- the pass's launcher refuses CPU tensors, and its counters and kernel
  names are in ``cuda_warp``'s tables and in ``csrc/warp.cu``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixray_tpu.ops import pallas_warp as PW

from pixray_tpu_torch.engine.cutouts import bank_order, cut_transforms, draw_cut_params
from pixray_tpu_torch.ops import cuda_warp
from pixray_tpu_torch.ops import warp as W
from pixray_tpu_torch.ops import warp_batch as WB
from pixray_tpu_torch.ops.warp import inv3x3


def _halves(s_w: float) -> np.ndarray:
    """float32 values v in (-s_w, s_w) with f32(f32(v / s_w) * 127) an exact
    half k + 0.5, for k both even and odd (the floats within 8 ulps of
    (k + 0.5) s_w / 127 that land there)."""
    s, out = np.float32(s_w), []
    for k in range(-127, 127):
        v = np.float32((k + 0.5) * s_w / 127.0)
        near = v + np.arange(-8, 9, dtype=np.float32) * np.spacing(v)
        hit = near[np.float32(near / s) * np.float32(127.0) == np.float32(k + 0.5)]
        out.extend(hit[:1])
    return np.asarray(out, dtype=np.float32)


def _tie_canvas(h, w, gen):
    """chip_smoke.py's tie-rich canvas: gray, r = g, r = b, exact 0 and 1, one channel at 1."""
    work = torch.rand((h, w, 3), generator=gen)
    work[: h // 3] = work[: h // 3, :, :1]
    work[h // 3: h // 2, :, 1] = work[h // 3: h // 2, :, 0]
    work[h // 2: 3 * h // 5, :, 2] = work[h // 2: 3 * h // 5, :, 0]
    work[3 * h // 5: 2 * h // 3] = 0.0
    work[2 * h // 3: 3 * h // 4] = 1.0
    work[3 * h // 4: 5 * h // 6, :, 0] = 1.0
    return work


def _canvas(kind):
    rng = np.random.default_rng(7)
    if kind == "ties":
        return _tie_canvas(90, 100, torch.Generator().manual_seed(3))
    s_w = {"halves at 1": 1.0, "halves at 0.37": 0.37, "halves at 2": 2.0}[kind]
    work = rng.uniform(-s_w, s_w, (24, 20, 3)).astype(np.float32)
    halves = _halves(s_w)
    assert halves.size >= 200
    work.reshape(-1)[:200] = halves[:200]
    work[15, 7, 1], work[21, 3, 2] = s_w, -s_w  # the codes +127 and -127
    return torch.tensor(work)


@pytest.mark.parametrize("kind", ["halves at 1", "halves at 0.37", "halves at 2", "ties"])
def test_packed_texels_are_quantize_canvas(kind):
    work = _canvas(kind)
    codes, s_w = WB.quantize_canvas(work)
    x = work.numpy()
    s_np = np.float32(max(np.abs(x).max(), np.float32(1e-6)))
    assert float(s_w) == s_np
    want = np.rint((x / s_np).astype(np.float32) * np.float32(127.0)).astype(np.int8)  # rint: half to even
    assert np.array_equal(codes.numpy(), want)
    packed = WB.pack_texels(codes)
    unpacked = torch.stack([((packed >> (8 * c)) & 0xFF).to(torch.uint8).view(torch.int8) for c in range(3)], -1)
    assert packed.dtype == torch.int32 and packed.shape == work.shape[:2]
    assert torch.equal(unpacked, codes) and int((packed >> 24).abs().max()) == 0
    if kind != "ties":
        assert {127, -127} <= set(codes.reshape(-1).tolist())
        pre = (work.reshape(-1)[:200] / s_w) * 127.0
        assert torch.equal(pre - torch.floor(pre), torch.full_like(pre, 0.5))  # every one an exact half
        rounded = codes.reshape(-1)[:200].to(torch.int32)
        assert bool((rounded % 2 == 0).all())  # half to even


def _ragged_bank():
    """chip_smoke.py phase 3b's ragged bank: zoomed-out boxes past the canvas and perspective cuts."""
    gen = torch.Generator().manual_seed(0)
    h, w, s = 90, 100, 40
    t = lambda *a: torch.tensor(a, dtype=torch.float32)
    boxes = W.crop_box_transform(t(0.0, 10.0, -120.0, 5.0, 0.0, -140.0), t(0.0, 2.0, -100.0, 20.0, 0.0, -90.0),
                                 t(100.0, 30.0, 350.0, 60.0, 100.0, 380.0), t(90.0, 28.0, 300.0, 50.0, 90.0, 270.0),
                                 s, s)
    persp = W.mm3(W.crop_box_transform(t(5.0, -10.0, 20.0), t(0.0, 10.0, -5.0), t(90.0, 80.0, 60.0),
                                       t(85.0, 70.0, 95.0), s, s),
                  W.random_perspective(h, w, 0.5, torch.rand((3, 4, 2), generator=gen)))
    return torch.cat([boxes, persp]), torch.tensor([1, 0, 0, 3, 3, 3, 3, 2, 0], dtype=torch.int32), (h, w, 3), s


def _flagship_bank(n, s):
    """n cuts of s on an s x s canvas, drawn as chip_smoke.py's flagship bank (zoom cuts by reflection and
    border, wide cuts over a fill; some with perspective)."""
    gen = torch.Generator().manual_seed(0)
    aspect = 384 / 216
    zoom, wide = cut_transforms(draw_cut_params(gen, n, aspect), s, aspect)
    order = bank_order(zoom.shape[0], wide.shape[0])
    modes = torch.tensor([i % 2 for i in range(zoom.shape[0])] + [3] * wide.shape[0], dtype=torch.int32)[order]
    return torch.cat([zoom, wide])[order], modes, (s, s, 3), s


def _brute_force_rows(inv, modes, shape, s):
    h, w, _ = shape
    idx, valid = WB._rung_taps(shape, inv, modes, 0.0, s)[:2]
    rows = (idx // w).numpy()
    valid = valid.numpy()
    out = np.empty((inv.shape[0], s, 2), dtype=np.int64)
    for n in range(inv.shape[0]):
        for i in range(s):
            hit = rows[:, n, i][valid[:, n, i]]
            out[n, i] = (hit.min(), hit.max()) if hit.size else WB.ROWS_EMPTY
    return out


@pytest.mark.parametrize("bank", ["ragged ties", "8 cuts of 384", "perspective modes"])
def test_row_table_is_the_taps_brute_force(bank):
    if bank == "ragged ties":
        ms, modes, shape, s = _ragged_bank()
    elif bank == "8 cuts of 384":
        ms, modes, shape, s = _flagship_bank(8, 384)
    else:  # every mode on one perspective bank, and a cut far off the canvas
        from test_torch_warp import H, W_, S, _perspective_bank

        ms = torch.tensor(_perspective_bank(8, seed=4))
        ms[7] = W.mm3(torch.tensor([[1.0, 0.0, 500.0], [0.0, 1.0, 500.0], [0.0, 0.0, 1.0]])[None], ms[7:8])[0]
        modes, shape, s = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.int32), (H, W_, 3), S
    inv = inv3x3(ms.float())
    got = WB.tap_row_ranges(inv, modes, shape, s)
    assert got.dtype == torch.int32 and tuple(got.shape) == (ms.shape[0], s, 2)
    want = _brute_force_rows(inv, modes, shape, s)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[..., 0] <= got[..., 1]).any() and (got[..., 0] >= 0).all()
    if bank != "8 cuts of 384":
        assert (got[..., 0] > got[..., 1]).any()  # some row with no tap on the canvas


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cotangent_bank_is_the_epilogue_adjoint(dtype):
    """The ragged tie-rich bank through the warp, the jitter on its cuts
    drawn with apply set on some (gray, clip-bound and tied pixels among
    them), and a cotangent: ``bank_cotangent_plain`` against autograd of
    ``bank_epilogue_plain`` (no noise: its adjoint is the identity)."""
    from pixray_tpu_torch.ops.color import draw_jitter_params

    ms, modes, shape, s = _ragged_bank()
    gen = torch.Generator().manual_seed(5)
    n = ms.shape[0]
    jitter = draw_jitter_params(gen, n, p=0.7)
    params = cuda_warp.pack_params(inv3x3(ms.float()), modes, jitter, fill=0.5)
    work = _tie_canvas(*shape[:2], torch.Generator().manual_seed(3))
    pre = WB.warp_modes_plain(work, inv3x3(ms.float()), modes, 0.5, s).to(dtype).requires_grad_(True)
    g = torch.randn((n, 3, s, s), generator=gen).to(dtype)
    (want,) = torch.autograd.grad(cuda_warp.bank_epilogue_plain(pre, params), pre, g)
    got, s_g = cuda_warp.bank_cotangent_plain(g, pre.detach(), params)
    apply = jitter[2]
    assert got.dtype == dtype and 0 < int(apply.sum()) < n
    assert torch.equal(got[~apply], g[~apply])
    scale = float(want.float().abs().max())
    ulp = 0.0 if dtype == torch.float32 else 2.0 ** -8
    cancel = 1e-5 if dtype == torch.float32 else 4e-5
    err = (got.float() - want.float()).abs()
    assert bool((err <= ulp * want.float().abs() + cancel * scale).all()), float(err.max())
    assert float((got[apply].float() - g[apply].float()).abs().max()) > 1e-2 * scale  # the adjoint moved it
    assert float(s_g) == float(got.float().abs().max())
    same, s_same = cuda_warp.bank_cotangent_plain(g, None, params)
    assert same is g and float(s_same) == float(g.float().abs().max())
    assert float(cuda_warp.bank_cotangent_plain(torch.zeros_like(g), None, params)[1]) == np.float32(1e-20)


def test_k2_rung_passes_refuse_cpu_tensors():
    """K2-int8's cotangent pass launches only on CUDA tensors; the rung's
    wrapper on the CPU is the plain twin (no kernel, no launch)."""
    ms, modes, shape, s = _ragged_bank()
    params = cuda_warp.pack_params(inv3x3(ms.float()), modes, fill=0.5)
    g = torch.zeros((ms.shape[0], 3, s, s))
    with pytest.raises(ValueError):
        cuda_warp.launch_bank_cotangent(g, None, params, shape)
    before = dict(cuda_warp.LAUNCHES)
    work = _tie_canvas(*shape[:2], torch.Generator().manual_seed(3)).requires_grad_(True)
    for prec in ("int8", "high"):
        out = cuda_warp.cutout_bank(work, params, s, None, torch.bfloat16, "int8" if prec == "int8" else prec, prec)
        out.float().sum().backward()
    assert cuda_warp.LAUNCHES == before and torch.isfinite(work.grad).all()


def _boundary_canvas(h=24, w=20):
    """Seeded float32 canvas whose values sit at bf16 rounding boundaries:
    exact halves between two bf16 values (low 16 bits 0x8000, the bf16
    part's last bit even and odd), one float32 ulp either side of them,
    values bf16 holds exactly, signed zeros, negatives, over [-4, 4]."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-4.0, 4.0, (h, w, 3)).astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    offsets = np.array([0x8000, 0x7FFF, 0x8001, 0x0000, 0x0001, 0xFFFF], dtype=np.uint32)
    bits = base | offsets[rng.integers(0, offsets.size, base.shape)]
    work = bits.view(np.float32).copy()
    work[0, :4] = [[0.0, -0.0, 1.0], [-1.0, 0.5, -0.5], [0.0, 0.0, 0.0], [-0.0, -0.0, -0.0]]
    return torch.tensor(work)


def _texel_canvas(kind):
    if kind == "ties":
        return _tie_canvas(90, 100, torch.Generator().manual_seed(3))
    if kind == "negatives":
        return torch.tensor(np.random.default_rng(5).normal(0.0, 2.0, (30, 26, 3)).astype(np.float32))
    return _boundary_canvas()


@pytest.mark.parametrize("prec", ["bf16", "high"])
@pytest.mark.parametrize("kind", ["ties", "negatives", "boundaries"])
def test_bf16_texels_are_the_mm_splits(kind, prec):
    work = _texel_canvas(kind)
    h, w, _ = work.shape
    texels = WB.pack_bf16_texels(work, prec)
    assert texels.dtype == torch.bfloat16 and tuple(texels.shape) == (h, w, 4 if prec == "bf16" else 8)
    bits = texels.view(torch.int16).numpy()
    a = jnp.asarray(work.numpy())
    a_hi = a.astype(jnp.bfloat16)  # _mm's a split (pallas_warp.py :67, :71, :73)
    a_lo = (a - a_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(bits[..., :3], np.asarray(a_hi).view(np.int16))
    if prec == "high":
        np.testing.assert_array_equal(bits[..., 3:6], np.asarray(a_lo).view(np.int16))
    assert not bits[..., 3 if prec == "bf16" else 6:].any()
    if kind == "boundaries":  # ties broken to even, both ways
        low = work.numpy().view(np.uint32) & 0xFFFF
        hi_bits = bits[..., :3].view(np.uint16)
        ties = low == 0x8000
        assert {0, 1} <= set((work.numpy().view(np.uint32)[ties] >> 16 & 1).tolist())
        assert not (hi_bits[ties] & 1).any()
    # the splits as _mm uses them: against an identity, "bf16" gives a_hi and "high" a_hi + a_lo
    rows = jnp.asarray(work.numpy().reshape(-1, 6))
    got = np.asarray(PW._mm(rows, jnp.eye(6, dtype=jnp.float32), prec)).reshape(work.shape)
    split = texels[..., :3].float() + (texels[..., 3:6].float() if prec == "high" else 0.0)
    np.testing.assert_array_equal(split.numpy(), got)


def _texel_warp(texels, inv, modes, fill, out_size, prec):
    """A plain warp from the pack pass's texels, as K1-bf16 and K1-high form
    it: one texel per tap for the three channels, the y hats split once,
    each column the sum of two bf16 products (each exact in f32), high's
    (d1 + d2) + d3, then the x hats and the fill."""
    h, w, _ = texels.shape
    idx, valid, hx, hy, cover, fill = WB._rung_taps((h, w, 3), inv, modes, fill, out_size)
    flat = texels.reshape(h * w, -1)

    def tap(k):  # (N, 8 or 4, S, S) float32: hi r, g, b (then lo r, g, b)
        vals = flat.index_select(0, idx[k].reshape(-1)).reshape(*idx[k].shape, -1).permute(0, 3, 1, 2).float()
        return torch.where(valid[k][:, None], vals, torch.zeros(()))

    t00, t01, t10, t11 = (tap(k) for k in range(4))
    by0, by1 = (x.to(torch.bfloat16).float()[:, None] for x in hy)
    ly0, ly1 = ((x - x.to(torch.bfloat16).float()).to(torch.bfloat16).float()[:, None] for x in hy)

    def dot2(a, b, c, d):
        for x, y in ((a, b), (c, d)):  # exact: the float64 product equals the float32 one
            assert torch.equal((x.double() * y.double()).float().double(), x.double() * y.double())
        return a * b + c * d

    def column(top, bot):
        d1 = dot2(top[:, :3], by0, bot[:, :3], by1)
        if prec == "bf16":
            return d1
        return (d1 + dot2(top[:, 3:6], by0, bot[:, 3:6], by1)) + dot2(top[:, :3], ly0, bot[:, :3], ly1)

    return column(t00, t10) * hx[0][:, None] + column(t01, t11) * hx[1][:, None] + cover * fill


@pytest.mark.parametrize("prec", ["bf16", "high"])
@pytest.mark.parametrize("bank", ["ragged ties", "perspective modes"])
def test_warp_from_texels_is_the_rung(bank, prec):
    if bank == "ragged ties":
        ms, modes, shape, s = _ragged_bank()
        work, fill = _tie_canvas(*shape[:2], torch.Generator().manual_seed(3)), 0.5
    else:
        from test_torch_warp import S, _perspective_bank

        ms, s, fill = torch.tensor(_perspective_bank(8, seed=4)), S, 0.4
        modes = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.int32)
        work = _boundary_canvas()
    inv = inv3x3(ms.float())
    want = WB.warp_modes_rung(work, inv, modes, fill, s, prec)
    got = _texel_warp(WB.pack_bf16_texels(work, prec), inv, modes, fill, s, prec)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0.1


def test_texel_pack_refuses_cpu_tensors():
    """K1-bf16's and K1-high's pack pass launches only on CUDA tensors; on
    the CPU the rungs' wrapper is the plain twin (no kernel, no launch)."""
    ms, modes, shape, s = _ragged_bank()
    work = _tie_canvas(*shape[:2], torch.Generator().manual_seed(3))
    for prec in ("bf16", "high"):
        with pytest.raises(ValueError):
            cuda_warp.launch_canvas_texels(work, prec)
    params = cuda_warp.pack_params(inv3x3(ms.float()), modes, fill=0.5)
    before = dict(cuda_warp.LAUNCHES)
    grad_work = work.clone().requires_grad_(True)
    for prec in ("bf16", "high"):
        out = cuda_warp.cutout_bank(grad_work, params, s, None, torch.bfloat16, prec)
        out.float().sum().backward()
    assert cuda_warp.LAUNCHES == before and torch.isfinite(grad_work.grad).all()


def test_pack_pass_is_named():
    """The pass is counted by name: a helper of each rung's K1 counter, a
    launch counter of its own, and a kernel of ``csrc/warp.cu`` under the
    name the profiler reports, as every counted kernel is."""
    for prec in ("bf16", "high"):
        counter = f"warp_fwd_{prec}_pack"
        assert cuda_warp.HELPERS[cuda_warp.FWD_COUNTERS[prec]] == (counter,)
        assert cuda_warp.KERNEL_NAMES[counter] == f"bank_{prec}_pack_kernel"
        assert counter in cuda_warp.LAUNCHES
    with open(cuda_warp.SOURCE) as f:
        source = f.read()
    kernels = set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", source))
    assert set(cuda_warp.LAUNCHES) == set(cuda_warp.KERNEL_NAMES)
    assert set(cuda_warp.KERNEL_NAMES.values()) <= kernels, set(cuda_warp.KERNEL_NAMES.values()) - kernels
