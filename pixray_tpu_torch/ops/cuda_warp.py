"""CUDA cutout-bank warp: kernels K1 (forward) and K2 (adjoint) on Hopper.

Replaces ``pixray_tpu/ops/pallas_warp.py``'s ``_fwd_kernel_multi_T`` and
``_bwd_kernel_multi_TB`` (and, since they take a mode per cut and compute
the full adjoint, the file's other kernel bodies).  The CUDA source is
``csrc/warp.cu``; it says what bounds the kernels on the card and how.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface under ``pixray_tpu_torch/_build/`` at first use
(rebuilt when the source is newer), loaded with ``ctypes``.  Nothing is
built or imported for CUDA when this module is imported.

Dispatch: :func:`warp_batch_modes` runs the kernels for CUDA tensors and
the plain version (``ops/warp_batch.py``) only for CPU tensors.  There is no
fallback: a CUDA tensor either launches the kernel or raises.

``LAUNCHES`` counts kernel launches (incremented only where a kernel is
launched), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pixray_tpu_torch.ops.nvcc import build_library, library_path, source_path
from pixray_tpu_torch.ops.warp import inv3x3
from pixray_tpu_torch.ops.warp_batch import modes_with_fill, warp_modes_plain

SOURCE = source_path("warp.cu")
LIBRARY = library_path("libpixray_warp.so")

LAUNCHES = {"warp_fwd": 0, "warp_bwd": 0}

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
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.warp_modes_fwd.argtypes = [ptr, ptr, ptr, f32, ptr, i32, i32, i32, i32, i32, ptr]
            lib.warp_modes_fwd.restype = i32
            lib.warp_modes_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
            lib.warp_modes_bwd.restype = i32
            _lib = lib
        return _lib


def _check_inputs(work_like, inv, modes):
    dev = work_like.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA warp kernels need CUDA tensors, got {dev}")
    for name, t, dtype in (("inv", inv, torch.float32), ("modes", modes, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}; "
                             f"got {t.dtype} on {t.device}")
    if inv.dim() != 3 or inv.shape[1:] != (3, 3) or modes.shape != (inv.shape[0],):
        raise ValueError(f"inv must be (N, 3, 3) and modes (N,): {tuple(inv.shape)}, {tuple(modes.shape)}")


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def launch_fwd(work, inv, modes, fill: float, out_size: int):
    """K1: (H, W, C) f32 canvas → (N, C, S, S) f32 bank."""
    _check_inputs(work, inv, modes)
    if work.dtype != torch.float32 or work.dim() != 3 or not work.is_contiguous():
        raise ValueError(f"work must be a contiguous (H, W, C) float32 tensor; got "
                         f"{work.dtype} {tuple(work.shape)}")
    h, w, c = work.shape
    n = inv.shape[0]
    out = torch.empty((n, c, out_size, out_size), dtype=torch.float32, device=work.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(work.device).cuda_stream
    code = _library().warp_modes_fwd(work.data_ptr(), inv.data_ptr(), modes.data_ptr(),
                                     float(fill), out.data_ptr(), n, h, w, c, out_size, stream)
    _raise_on(code, "warp_modes_fwd")
    LAUNCHES["warp_fwd"] += 1
    return out


def launch_bwd(g, inv, modes, work_shape, out_size: int):
    """K2: (N, C, S, S) f32 cotangent → (H, W, C) f32 canvas gradient."""
    _check_inputs(g, inv, modes)
    h, w, c = work_shape
    n = inv.shape[0]
    if g.dtype != torch.float32 or g.shape != (n, c, out_size, out_size) or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous float32 {(n, c, out_size, out_size)} tensor; "
                         f"got {g.dtype} {tuple(g.shape)}")
    dwork = torch.zeros((h, w, c), dtype=torch.float32, device=g.device)
    if n == 0:
        return dwork
    stream = torch.cuda.current_stream(g.device).cuda_stream
    code = _library().warp_modes_bwd(g.data_ptr(), inv.data_ptr(), modes.data_ptr(),
                                     dwork.data_ptr(), n, h, w, c, out_size, stream)
    _raise_on(code, "warp_modes_bwd")
    LAUNCHES["warp_bwd"] += 1
    return dwork


class WarpModesFunction(torch.autograd.Function):
    """K1 forward, K2 backward.  The gradient flows to ``work`` only."""

    @staticmethod
    def forward(ctx, work, inv, modes, fill, out_size):
        ctx.save_for_backward(inv, modes)
        ctx.work_shape = tuple(work.shape)
        ctx.out_size = out_size
        return launch_fwd(work, inv, modes, fill, out_size)

    @staticmethod
    def backward(ctx, g):
        inv, modes = ctx.saved_tensors
        dwork = launch_bwd(g.float().contiguous(), inv, modes, ctx.work_shape, ctx.out_size)
        return dwork, None, None, None, None


def warp_modes(work, inv, modes, fill: float, out_size: int):
    """(H, W, C) canvas, (N, 3, 3) inverse matrices, (N,) int32 modes → (N, C, S, S).

    CUDA tensors go through the kernels; CPU tensors through the plain version."""
    if work.device.type == "cuda":
        return WarpModesFunction.apply(work.contiguous(), inv, modes, float(fill), out_size)
    if work.device.type == "cpu":
        return warp_modes_plain(work, inv, modes, float(fill), out_size)
    raise ValueError(f"unsupported device for the cutout warp: {work.device}")


def warp_batch_modes(work, matrices, modes, out_size: int, fill_value=0.0,
                     fill_mask=None):
    """Mixed-mode bank warp (the JAX ``pallas_warp_batch_modes`` contract, nchw).

    matrices: (N, 3, 3) src→dst; modes: (N,) 0 reflection / 1 border /
    2 zeros; fill_mask: optional (N,) bool of cuts composited over
    ``fill_value``.  The inverse matrices are computed where ``matrices``
    lie (the engine keeps them on the host) and copied to the canvas."""
    inv = inv3x3(matrices.float()).to(work.device, non_blocking=True).contiguous()
    modes = modes_with_fill(modes, fill_mask).to(work.device, non_blocking=True).contiguous()
    return warp_modes(work, inv, modes, float(fill_value), out_size)
