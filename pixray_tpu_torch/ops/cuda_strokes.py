"""CUDA Bézier-stroke rasterizer: kernels K4 (forward), K4s (forward that
stores each chunk's entry canvas) and K5 (backward) on Hopper.

Replaces ``pixray_tpu/ops/pallas_strokes.py``'s ``_fwd_kernel``,
``_fwd_store_kernel`` and ``_bwd_kernel``.  The CUDA source is
``csrc/strokes.cu``; it says what bounds the kernels on the card and how.
The plain version of all three is ``ops/strokes.py``.

Build: ``ops/nvcc.py`` (nvcc for ``sm_90a`` into ``_build/`` at first use,
loaded with ``ctypes``).  Nothing is built when this module is imported.

Dispatch: :func:`render_strokes_auto` runs the kernels for CUDA tensors and
the plain version only for CPU tensors; a CUDA tensor launches the kernel
or raises.  With a gradient to take, the forward is K4s and the backward
K5 (``StrokesFunction``); without one (a checkin render under
``torch.no_grad()``) the forward is K4.  The sampling product
``basis @ points`` and its transpose stay plain ``torch`` outside the
kernels, as in the JAX function.

The backward differs from the TPU kernel on purpose: it does not skip a
stroke whose alpha is <= 0, so such a stroke gets the alpha gradient that
``render_strokes`` gives it (the TPU kernel gives 0, and Adam can then
never bring a stroke back from alpha 0).

``LAUNCHES`` counts kernel launches (incremented only where a kernel is
launched), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pixray_tpu_torch.ops.nvcc import build_library, library_path, source_path
from pixray_tpu_torch.ops.strokes import CHUNK, premultiply, render_strokes, sample_paths, unpremultiply

SOURCE = source_path("strokes.cu")
LIBRARY = library_path("libpixray_strokes.so")

LAUNCHES = {"strokes_fwd": 0, "strokes_fwd_store": 0, "strokes_bwd": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build(force: bool = False) -> str:
    """Compile ``csrc/strokes.cu`` if the library is missing or older than it."""
    return build_library(SOURCE, LIBRARY, force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.strokes_chunk.argtypes = []
            lib.strokes_chunk.restype = i32
            lib.strokes_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.strokes_fwd.restype = i32
            lib.strokes_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.strokes_bwd.restype = i32
            if lib.strokes_chunk() != CHUNK:
                raise RuntimeError(f"csrc/strokes.cu chunks {lib.strokes_chunk()} strokes, ops/strokes.py {CHUNK}")
            _lib = lib
        return _lib


def pack_meta(samples, widths, colors):
    """(N, 9) rows [width, r, g, b, a, bx0, by0, bx1, by1]: per-stroke scalars
    and the bbox with the anti-aliasing margin (JAX ``_pack_meta``)."""
    margin = widths[:, None] / 2.0 + 1.0  # ramp reaches width/2 + 0.5; +slack
    mn = torch.amin(samples, dim=1)  # (N, 2) [x, y]
    mx = torch.amax(samples, dim=1)
    return torch.cat([widths[:, None], colors, mn - margin, mx + margin], dim=-1).float().contiguous()


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {device}; "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_strokes(samples, meta, canvas_like):
    dev = samples.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA stroke kernels need CUDA tensors, got {dev}")
    if samples.dim() != 3 or samples.shape[2] != 2 or samples.shape[1] < 2:
        raise ValueError(f"samples must be (N, P >= 2, 2); got {tuple(samples.shape)}")
    n, p, _ = samples.shape
    _check("samples", samples, (n, p, 2), dev)
    _check("meta", meta, (n, 9), dev)
    if canvas_like.dim() != 3 or canvas_like.shape[0] != 4:
        raise ValueError(f"canvas tensors must be (4, H, W); got {tuple(canvas_like.shape)}")
    _check("canvas", canvas_like, tuple(canvas_like.shape), dev)
    return n, p


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def launch_fwd(samples, meta, bg_premult, store: bool = False):
    """K4 (or K4s with ``store``): (N, P, 2) samples, (N, 9) meta, (4, H, W)
    premultiplied background → (4, H, W) premultiplied canvas [, (ceil(N/16),
    4, H, W) canvases at each chunk's entry]."""
    n, p = _check_strokes(samples, meta, bg_premult)
    _, h, w = bg_premult.shape
    out = torch.empty((4, h, w), dtype=torch.float32, device=samples.device)
    n_chunks = -(-n // CHUNK)
    prefixes = torch.empty((n_chunks, 4, h, w), dtype=torch.float32, device=samples.device) if store else None
    stream = torch.cuda.current_stream(samples.device).cuda_stream
    stores = store and n > 0  # with no strokes there is no prefix to store: K4
    code = _library().strokes_fwd(samples.data_ptr(), meta.data_ptr(), bg_premult.data_ptr(),
                                  out.data_ptr(), prefixes.data_ptr() if stores else None,
                                  n, p, h, w, stream)
    _raise_on(code, "strokes_fwd")
    LAUNCHES["strokes_fwd_store" if stores else "strokes_fwd"] += 1
    return (out, prefixes) if store else out


def launch_bwd(g, samples, meta, prefixes):
    """K5: (4, H, W) cotangent of the premultiplied canvas → dsamples (N, P, 2),
    dmeta (N, 5) [dwidth, dr, dg, db, dalpha], dbg (4, H, W)."""
    n, p = _check_strokes(samples, meta, g)
    _, h, w = g.shape
    _check("prefixes", prefixes, (-(-n // CHUNK), 4, h, w), samples.device)
    dsamples = torch.zeros((n, p, 2), dtype=torch.float32, device=samples.device)
    dmeta = torch.zeros((n, 5), dtype=torch.float32, device=samples.device)
    dbg = torch.empty((4, h, w), dtype=torch.float32, device=samples.device)
    stream = torch.cuda.current_stream(samples.device).cuda_stream
    code = _library().strokes_bwd(g.data_ptr(), samples.data_ptr(), meta.data_ptr(),
                                  prefixes.data_ptr() if n else None, dsamples.data_ptr(),
                                  dmeta.data_ptr(), dbg.data_ptr(), n, p, h, w, stream)
    _raise_on(code, "strokes_bwd")
    LAUNCHES["strokes_bwd"] += 1
    return dsamples, dmeta, dbg


class StrokesFunction(torch.autograd.Function):
    """K4s forward, K5 backward: (N, P, 2) samples, (N,) widths, (N, 4)
    colors, (4, H, W) premultiplied background → (4, H, W) premultiplied canvas."""

    @staticmethod
    def forward(ctx, samples, widths, colors, bg_premult):
        meta = pack_meta(samples, widths, colors)
        canvas, prefixes = launch_fwd(samples, meta, bg_premult, store=True)
        ctx.save_for_backward(samples, meta, prefixes)
        return canvas

    @staticmethod
    def backward(ctx, g):
        samples, meta, prefixes = ctx.saved_tensors
        dsamples, dmeta, dbg = launch_bwd(g.float().contiguous(), samples, meta, prefixes)
        return dsamples, dmeta[:, 0], dmeta[:, 1:5], dbg


def render_premult(samples, widths, colors, bg_premult):
    """Paint strokes over a (4, H, W) premultiplied CUDA canvas with the kernels."""
    args = [t.float().contiguous() for t in (samples, widths, colors, bg_premult)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return StrokesFunction.apply(*args)
    return launch_fwd(args[0], pack_meta(*args[:3]), args[3])


def render_strokes_fused(points, widths, colors, basis, h: int, w: int, background):
    """``render_strokes`` through the CUDA kernels (same arguments and result)."""
    bg = premultiply(background)
    if bg.shape[:2] != (h, w):
        raise ValueError(f"background {tuple(background.shape)} is not {h}x{w}")
    canvas = render_premult(sample_paths(basis, points), widths, colors, bg.permute(2, 0, 1))
    return unpremultiply(canvas.permute(1, 2, 0))


def render_strokes_auto(points, widths, colors, basis, h: int, w: int, background):
    """(N, V, 2) points, (N,) widths, (N, 4) colors, (N, P, V) basis,
    (H, W, 3|4) background → (H, W, 4) straight-alpha canvas.

    CUDA tensors go through the kernels; CPU tensors through the plain version."""
    if points.device.type == "cuda":
        return render_strokes_fused(points, widths, colors, basis, h, w, background)
    if points.device.type == "cpu":
        return render_strokes(points, widths, colors, basis, h, w, background)
    raise ValueError(f"unsupported device for the stroke rasterizer: {points.device}")
