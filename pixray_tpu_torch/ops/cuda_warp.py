"""CUDA cutout bank: kernels K1 (forward) and K2 (adjoint) on Hopper.

K1 warps every cut of a perceptor's bank from the work canvas and applies
the epilogue (the compute-dtype rounding, the hue/saturation jitter and the
noise) in one launch; K2 takes the bank's cotangent through the epilogue's
adjoint and the warp's adjoint into the canvas gradient in one launch.
They replace ``pixray_tpu/ops/pallas_warp.py``'s ``_fwd_kernel_multi_T``
and ``_bwd_kernel_multi_TB`` (and, since they take a mode per cut and
compute the full adjoint, the file's other kernel bodies), the separable
matmul route of the axis-aligned cuts, and the epilogue XLA fused around
them (``pixray_tpu/engine/cutouts.py:397-425``).  The CUDA source is
``csrc/warp.cu``; it says what bounds the kernels on the card and how.

Build: ``ops/nvcc.py`` (nvcc for ``sm_90a`` into ``_build/`` at first use,
loaded with ``ctypes``).  Nothing is built or imported for CUDA when this
module is imported.

Per-cut parameters travel in one (N, 16) float32 row block
(:func:`pack_params`: inverse matrix, mode, hue shift, saturation factor,
apply, noise factor, fill), packed on the host and copied to the card: by
the engine once per step or, for a block of steps, once per block into
the rows a captured CUDA graph reads (``engine/step.py``).  The fill is a
field of the row, not a kernel argument, so that a graph replays each
step's own gray.  K1 always saves the pre-jitter bank of the engine's
banks (it writes only the rows whose ``apply`` is set, and K2 reads no
other), so no host test of the jitter decides it.

Dispatch: :func:`cutout_bank` and :func:`warp_modes` run the kernels for
CUDA tensors and the plain version (:func:`cutout_bank_plain`, built on
``ops/warp_batch.py`` and ``ops/color.py``) only for CPU tensors.  There is
no fallback: a CUDA tensor either launches the kernel or raises.  With no
jitter, no noise and float32 output the kernels are the bare warp
(:func:`warp_modes`, :func:`warp_batch_modes`).

Precision rungs (``prec`` of K1, ``bwd`` of K2; ``config/precision.py``):
"highest" is the exact warp, "bf16", "high" and "int8" the variants of
``csrc/warp.cu`` with the JAX package's rung functions, whose plain
versions are ``ops/warp_batch.py``'s ``warp_modes_prec``.  K1-int8 takes
the canvas quantized on the device (``quantize_canvas``: its scale is a
device scalar, never read on the host); K2-int8 takes the bank's max|g|
in a first pass and sums in int64.

``LAUNCHES`` counts kernel launches (incremented only where a kernel is
launched), one counter per rung of each kernel ("warp_fwd" and
"warp_bwd" the exact rung), so a run can show that its path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pixray_tpu_torch.ops.color import random_color_jitter_planes
from pixray_tpu_torch.ops.nvcc import build_library, library_path, source_path
from pixray_tpu_torch.ops.warp import inv3x3
from pixray_tpu_torch.ops.warp_batch import (MODE_BORDER, MODE_FILL, MODE_REFLECT, MODE_ZEROS, WARP_PRECS,
                                              modes_with_fill, norm_prec, quantize_canvas,
                                              warp_modes_prec)

SOURCE = source_path("warp.cu")
LIBRARY = library_path("libpixray_warp.so")

PARAM_STRIDE = 16  # floats per cut: inverse (9), mode, hue, saturation, apply, noise factor, fill
_MODE, _HUE, _SAT, _APPLY, _FAC, _FILL = 9, 10, 11, 12, 13, 14
_LAYOUT = (PARAM_STRIDE, _MODE, _HUE, _SAT, _APPLY, _FAC, _FILL)  # as csrc/warp.cu's bank_layout() reports it
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_PREC_CODES = {"highest": 0, "bf16": 1, "high": 2, "int8": 3}  # as csrc/warp.cu's Prec
FWD_COUNTERS = {"highest": "warp_fwd", "bf16": "warp_fwd_bf16", "high": "warp_fwd_high", "int8": "warp_fwd_int8"}
BWD_COUNTERS = {"highest": "warp_bwd", "bf16": "warp_bwd_bf16", "high": "warp_bwd_high", "int8": "warp_bwd_int8"}
# the kernels' names (the profiler's), by counter
KERNEL_NAMES = {"warp_fwd": "bank_fwd_kernel", "warp_fwd_bf16": "bank_fwd_bf16_kernel",
                "warp_fwd_high": "bank_fwd_high_kernel", "warp_fwd_int8": "bank_fwd_int8_kernel",
                "warp_bwd": "bank_bwd_kernel", "warp_bwd_bf16": "bank_bwd_bf16_kernel",
                "warp_bwd_high": "bank_bwd_high_kernel", "warp_bwd_int8": "bank_bwd_int8_kernel"}

LAUNCHES = {name: 0 for name in (*FWD_COUNTERS.values(), *BWD_COUNTERS.values())}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build(force: bool = False) -> str:
    """Compile ``csrc/warp.cu`` if the library is missing or older than it."""
    return build_library(SOURCE, LIBRARY, force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.bank_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
            lib.bank_fwd.restype = i32
            lib.bank_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
            lib.bank_bwd.restype = i32
            lib.bank_layout.argtypes = [ptr]
            lib.bank_layout.restype = None
            layout = (ctypes.c_int * len(_LAYOUT))()
            lib.bank_layout(layout)
            if tuple(layout) != _LAYOUT:
                raise RuntimeError(f"csrc/warp.cu lays out a cut's parameters as {tuple(layout)} "
                                   f"(stride, mode, hue, sat, apply, fac, fill), ops/cuda_warp.py as {_LAYOUT}")
            _lib = lib
        return _lib


# ------------------------------------------------------------------ parameters
def pack_params(inv, modes, jitter=None, facs=None, fill: float = 0.0, out=None):
    """(N, PARAM_STRIDE) float32 host rows of a bank's per-cut parameters.

    inv: (N, 3, 3) inverse (dst→src) matrices; modes: (N,) 0-3; jitter:
    (hue_shift, sat_factor, apply) per cut or None; facs: noise factors (N
    values, already in the compute dtype) or None; fill: the gray of the
    mode-3 cuts.  ``out``: the (N, PARAM_STRIDE) host rows to write (a
    view of a staging buffer), else new ones."""
    n = inv.shape[0]
    buf = torch.zeros((n, PARAM_STRIDE), dtype=torch.float32) if out is None else out.zero_()
    buf[:, :9] = inv.detach().reshape(n, 9).float().cpu()
    buf[:, _MODE] = modes.cpu().float()
    if jitter is not None:
        hs, sf, apply = jitter
        buf[:, _HUE] = hs.cpu().float()
        buf[:, _SAT] = sf.cpu().float()
        buf[:, _APPLY] = apply.cpu().float()
    if facs is not None:
        buf[:, _FAC] = facs.detach().reshape(n).cpu().float()
    buf[:, _FILL] = float(fill)
    return buf


def unpack_params(params):
    """The inverse of :func:`pack_params`: a dict of inv (N, 3, 3), modes
    (N,) int32, hue, sat (N,) float32, apply (N,) bool, facs and fill (N,) float32."""
    return {
        "inv": params[:, :9].reshape(-1, 3, 3),
        "modes": params[:, _MODE].to(torch.int32),
        "hue": params[:, _HUE],
        "sat": params[:, _SAT],
        "apply": params[:, _APPLY] != 0,
        "facs": params[:, _FAC],
        "fill": params[:, _FILL],
    }


# ------------------------------------------------------------------ plain version
def bank_epilogue_plain(batch, params, planes=None):
    """The epilogue of a (N, 3, S, S) bank, in the bank's dtype: the jitter
    of the cuts whose ``apply`` is set, then ``p + fac * z`` per plane."""
    p = unpack_params(params)
    r, g, b = batch.unbind(1)
    if bool(p["apply"].any()):
        r, g, b = random_color_jitter_planes((p["hue"], p["sat"], p["apply"]), r, g, b)
    if planes is not None:
        facs = p["facs"].to(batch.device, r.dtype)[:, None, None]
        r, g, b = (x + facs * z for x, z in zip((r, g, b), planes))
    return torch.stack([r, g, b], dim=1)


def cutout_bank_plain(work, params, out_size: int, planes=None, compute_dtype=None, prec="highest", bwd=None):
    """The bank as a composition of plain ops: every cut through the warp at
    K1's rung ``prec`` with K2's rung ``bwd`` for its gradient
    (``warp_modes_prec``, each cut's fill from its row), the cast to
    ``compute_dtype``, then :func:`bank_epilogue_plain`."""
    p = unpack_params(params)
    batch = warp_modes_prec(work, p["inv"].to(work.device), p["modes"].to(work.device),
                            p["fill"].to(work.device), out_size, prec, bwd)
    if compute_dtype is not None:
        batch = batch.to(compute_dtype)
    return bank_epilogue_plain(batch, params, planes)


# ------------------------------------------------------------------ launchers
def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def _check(name, t, dev, dtype, shape):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} tensor on {dev}; "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_prec(prec):
    if prec not in WARP_PRECS:
        raise ValueError(f"warp rung must be one of {WARP_PRECS}; got {prec!r}")


def launch_bank_fwd(work, params, out_size: int, planes=None, out_dtype=torch.float32,
                    save_pre: bool = False, prec: str = "highest"):
    """K1 at rung ``prec``: (H, W, 3) f32 canvas and (N, PARAM_STRIDE)
    parameters on the card → ((N, 3, S, S) bank in ``out_dtype``, the
    rounded pre-jitter bank or None).  The pre-jitter bank holds the
    jittered cuts' rows only; the others are left unwritten, since K2 reads
    no other.  int8 quantizes the canvas on the device first."""
    _check_prec(prec)
    dev = work.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA bank kernels need CUDA tensors, got {dev}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"unsupported bank dtype {out_dtype}")
    if work.dim() != 3 or work.shape[2] != 3:
        raise ValueError(f"work must be (H, W, 3); got {tuple(work.shape)}")
    h, w, _ = work.shape
    _check("work", work, dev, torch.float32, work.shape)
    n = params.shape[0]
    _check("params", params, dev, torch.float32, (n, PARAM_STRIDE))
    zs = [None] * 3
    if planes is not None:
        for k, z in enumerate(planes):
            _check(f"noise plane {k}", z, dev, out_dtype, (n, out_size, out_size))
        zs = list(planes)
    out = torch.empty((n, 3, out_size, out_size), dtype=out_dtype, device=dev)
    pre = torch.empty_like(out) if save_pre else None
    if n == 0:
        return out, pre
    ptr = lambda t: None if t is None else t.data_ptr()
    src, scale = (work, None) if prec != "int8" else quantize_canvas(work)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _library().bank_fwd(src.data_ptr(), ptr(scale), params.data_ptr(), *map(ptr, zs), out.data_ptr(),
                               ptr(pre), _DTYPES[out_dtype], _PREC_CODES[prec], n, h, w, out_size, stream)
    _raise_on(code, f"bank_fwd ({prec})")
    LAUNCHES[FWD_COUNTERS[prec]] += 1
    return out, pre


def launch_bank_bwd(g, pre, params, work_shape, out_size: int, branches=None, prec: str = "highest"):
    """K2 at rung ``prec``: (N, 3, S, S) cotangent (the bank's dtype), the
    saved pre-jitter bank (None when no cut is jittered) and the parameters
    → (H, W, 3) f32.  ``branches``, a (2,) int32 tensor on the card, if
    given, gains the count of blocks that summed in shared memory and of
    those that added straight to device memory.  int8 sums in an int64
    canvas after a pass that takes the bank's max|g|."""
    _check_prec(prec)
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA bank kernels need CUDA tensors, got {dev}")
    if g.dtype not in _DTYPES:
        raise ValueError(f"unsupported bank dtype {g.dtype}")
    h, w, c = work_shape
    n = params.shape[0]
    _check("params", params, dev, torch.float32, (n, PARAM_STRIDE))
    _check("g", g, dev, g.dtype, (n, c, out_size, out_size))
    if pre is not None:
        _check("pre", pre, dev, g.dtype, g.shape)
    if branches is not None:
        _check("branches", branches, dev, torch.int32, (2,))
    dwork = torch.zeros((h, w, c), dtype=torch.float32, device=dev)
    if n == 0:
        return dwork
    acc = gmax = None
    if prec == "int8":
        acc = torch.zeros((h, w, c), dtype=torch.int64, device=dev)
        gmax = torch.zeros((1,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    code = _library().bank_bwd(g.data_ptr(), ptr(pre), params.data_ptr(), dwork.data_ptr(), ptr(acc), ptr(gmax),
                               ptr(branches), _DTYPES[g.dtype], _PREC_CODES[prec], n, h, w, out_size, stream)
    _raise_on(code, f"bank_bwd ({prec})")
    LAUNCHES[BWD_COUNTERS[prec]] += 1
    return dwork


def _warp_params(inv, modes, fill: float, dev):
    """The bare warp's parameter rows (no jitter, no noise) on ``dev``."""
    if inv.dim() != 3 or inv.shape[1:] != (3, 3) or modes.shape != (inv.shape[0],):
        raise ValueError(f"inv must be (N, 3, 3) and modes (N,): {tuple(inv.shape)}, {tuple(modes.shape)}")
    return pack_params(inv, modes, fill=fill).to(dev)


def launch_fwd(work, inv, modes, fill: float, out_size: int):
    """K1 as the bare warp: (H, W, 3) f32 canvas → (N, 3, S, S) f32 bank."""
    return launch_bank_fwd(work, _warp_params(inv, modes, fill, work.device), out_size)[0]


def launch_bwd(g, inv, modes, work_shape, out_size: int):
    """K2 as the bare warp's adjoint: (N, 3, S, S) f32 cotangent → (H, W, 3) f32."""
    return launch_bank_bwd(g, None, _warp_params(inv, modes, 0.0, g.device), work_shape, out_size)


class CutoutBankFunction(torch.autograd.Function):
    """K1 forward, K2 backward (each at its rung).  The gradient flows to ``work`` only."""

    @staticmethod
    def forward(ctx, work, params, out_size, out_dtype, save_pre, prec, bwd, z0, z1, z2):
        planes = None if z0 is None else (z0, z1, z2)
        out, pre = launch_bank_fwd(work, params, out_size, planes, out_dtype, save_pre=save_pre, prec=prec)
        ctx.save_for_backward(params, pre)
        ctx.work_shape = tuple(work.shape)
        ctx.out_size = out_size
        ctx.out_dtype = out_dtype
        ctx.bwd = bwd
        return out

    @staticmethod
    def backward(ctx, g):
        params, pre = ctx.saved_tensors
        g = g.to(ctx.out_dtype).contiguous()
        dwork = launch_bank_bwd(g, pre, params, ctx.work_shape, ctx.out_size, prec=ctx.bwd)
        return dwork, None, None, None, None, None, None, None, None, None


def cutout_bank(work, params, out_size: int, planes=None, compute_dtype=None, prec="highest", bwd=None):
    """(H, W, 3) canvas, per-cut parameters from :func:`pack_params` and
    optional noise planes (three (N, S, S) in the compute dtype) → (N, 3,
    S, S) bank in ``compute_dtype`` (None = float32).  ``prec``: K1's rung;
    ``bwd``: K2's (None: ``norm_prec(prec)``).

    CUDA tensors go through K1/K2 (``params`` on the card already, or
    copied there); CPU tensors through the plain version.  K1 saves the
    pre-jitter bank only for rows whose ``apply`` is set, and K2 reads it
    only for those.  A canvas that needs no gradient (a constant image, or
    under ``no_grad``) takes one K1 launch that saves nothing, and no K2."""
    bwd = norm_prec(prec) if bwd is None else bwd
    if work.device.type == "cuda":
        out_dtype = compute_dtype or torch.float32
        params_dev = params.to(work.device, non_blocking=True)
        zs = (None, None, None) if planes is None else tuple(z.contiguous() for z in planes)
        if not (torch.is_grad_enabled() and work.requires_grad):
            planes = None if planes is None else zs
            return launch_bank_fwd(work.contiguous(), params_dev, out_size, planes, out_dtype, prec=prec)[0]
        return CutoutBankFunction.apply(work.contiguous(), params_dev, out_size, out_dtype, True, prec, bwd, *zs)
    if work.device.type == "cpu":
        return cutout_bank_plain(work, params, out_size, planes, compute_dtype, prec, bwd)
    raise ValueError(f"unsupported device for the cutout bank: {work.device}")


def warp_modes(work, inv, modes, fill: float, out_size: int, prec="highest", bwd=None):
    """(H, W, 3) canvas, (N, 3, 3) inverse matrices, (N,) int32 modes → (N, 3, S, S) f32,
    K1 at rung ``prec``, K2 at ``bwd`` (None: ``norm_prec(prec)``).

    CUDA tensors go through the kernels; CPU tensors through the plain version."""
    bwd = norm_prec(prec) if bwd is None else bwd
    if work.device.type == "cuda":
        return CutoutBankFunction.apply(work.contiguous(), _warp_params(inv, modes, fill, work.device),
                                        out_size, torch.float32, False, prec, bwd, None, None, None)
    if work.device.type == "cpu":
        return warp_modes_prec(work, inv, modes, float(fill), out_size, prec, bwd)
    raise ValueError(f"unsupported device for the cutout warp: {work.device}")


def warp_batch_modes(work, matrices, modes, out_size: int, fill_value=0.0,
                     fill_mask=None, precision="highest", bwd=None):
    """Mixed-mode bank warp (the JAX ``pallas_warp_batch_modes`` contract, nchw).

    matrices: (N, 3, 3) src→dst; modes: (N,) 0 reflection / 1 border /
    2 zeros; fill_mask: optional (N,) bool of cuts composited over
    ``fill_value``; ``precision``/``bwd``: K1's and K2's rungs.  The inverse
    matrices are computed where ``matrices`` lie (the engine keeps them on
    the host) and copied to the canvas."""
    inv = inv3x3(matrices.float()).to(work.device, non_blocking=True).contiguous()
    modes = modes_with_fill(modes, fill_mask).to(work.device, non_blocking=True).contiguous()
    return warp_modes(work, inv, modes, float(fill_value), out_size, precision, bwd)


PADDING_MODES = {"reflection": MODE_REFLECT, "border": MODE_BORDER, "zeros": MODE_ZEROS, "fill": MODE_FILL}


def warp_batch(work, matrices, out_size: int, padding_mode="zeros", fill_value=0.0, precision="highest"):
    """Single-mode bank warp (the JAX ``pallas_warp_batch`` contract, nchw):
    every cut pads by ``padding_mode`` (reflection, border, zeros, or fill:
    zeros composited over ``fill_value``).  :func:`warp_batch_modes` with a
    constant mode column: on the card K1/K2 as the bare warp, both at
    ``norm_prec(precision)`` (the JAX single-mode kernels have no int8)."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"padding_mode must be one of {sorted(PADDING_MODES)}; got {padding_mode!r}")
    modes = torch.full((matrices.shape[0],), PADDING_MODES[padding_mode], dtype=torch.int32)
    prec = norm_prec(precision)
    return warp_batch_modes(work, matrices, modes, out_size, fill_value, precision=prec, bwd=prec)
