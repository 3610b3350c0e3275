"""CUDA Bézier-stroke rasterizer: kernels K4 (forward), K4s (forward that
saves each tile's stroke list and its chunk-entry tile canvases) and K5
(backward) on Hopper.

Replaces ``pixray_tpu/ops/pallas_strokes.py``'s ``_fwd_kernel``,
``_fwd_store_kernel`` and ``_bwd_kernel``.  The CUDA source is
``csrc/strokes.cu``; it says what bounds the kernels on the card and how.
The plain version of all three is ``ops/strokes.py``, with the plain twins
of the saved state (``tile_stroke_lists``, ``tile_chunk_canvases``).

Build: ``ops/nvcc.py`` (nvcc for ``sm_90a`` into ``_build/`` at first use,
loaded with ``ctypes``).  Nothing is built when this module is imported.

Dispatch: :func:`render_strokes_auto` runs the kernels for CUDA tensors and
the plain version only for CPU tensors; a CUDA tensor launches the kernel
or raises.  With a gradient to take, the forward is K4s and the backward
K5 (``StrokesFunction``); without one (a checkin render under
``torch.no_grad()``) the forward is K4.  The sampling product
``basis @ points`` and its transpose stay plain ``torch`` outside the
kernels, as in the JAX function; so does the samples' box (one
``aminmax``), from which the kernels compute each stroke's margined bbox.

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
from typing import NamedTuple

import torch

from pixray_tpu_torch.ops.nvcc import build_library, library_path, source_path
from pixray_tpu_torch.ops.strokes import TILE, premultiply, render_strokes, sample_paths, unpremultiply

SOURCE = source_path("strokes.cu")
LIBRARY = library_path("libpixray_strokes.so")
CANVAS_SLOT = (4, TILE[0], TILE[1])  # one saved tile canvas: channels, the tile's rows and columns

LAUNCHES = {"strokes_fwd": 0, "strokes_fwd_store": 0, "strokes_bwd": 0}

_lib = None
_lib_lock = threading.Lock()


class TileState(NamedTuple):
    """What K4s saves for K5.  ``lo``/``hi`` (N, 2): the samples' box;
    ``counts`` (T,) int32 and ``lists`` (T, N) int32: each tile's ascending
    list of the strokes that meet it (first ``counts[t]`` entries written);
    ``canvases`` (T, ceil(N/C), 4, 8, 16): the tile canvas at the entry of
    each C-stroke chunk of its list (first ceil(counts[t]/C) written), C =
    ``chunk_size(P)``.  T counts the tiles row-major."""
    lo: torch.Tensor
    hi: torch.Tensor
    counts: torch.Tensor
    lists: torch.Tensor
    canvases: torch.Tensor


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
            lib.strokes_tile_h.argtypes = []
            lib.strokes_tile_h.restype = i32
            lib.strokes_chunk.argtypes = [i32]
            lib.strokes_chunk.restype = i32
            lib.strokes_max_samples.argtypes = []
            lib.strokes_max_samples.restype = i32
            lib.strokes_fwd.argtypes = [ptr] * 10 + [i32] * 4 + [ptr]
            lib.strokes_fwd.restype = i32
            lib.strokes_bwd.argtypes = [ptr] * 12 + [i32] * 4 + [ptr]
            lib.strokes_bwd.restype = i32
            if lib.strokes_tile_h() != TILE[0]:
                raise RuntimeError(f"csrc/strokes.cu tiles {lib.strokes_tile_h()} rows, ops/strokes.py {TILE[0]}")
            _lib = lib
        return _lib


def chunk_size(p: int) -> int:
    """Strokes per chunk of a tile's list at P samples per stroke, as the
    kernels take them: 16 up to P = 294, fewer above (K5's shared memory)."""
    chunk = _library().strokes_chunk(p)
    if chunk == 0:
        raise ValueError(f"the stroke kernels take 2 to {_library().strokes_max_samples()} samples per stroke "
                         f"(shared memory); got {p}")
    return chunk


def _tile_count(h: int, w: int) -> int:
    """The number of tiles of the (H, W) canvas."""
    return -(-h // TILE[0]) * -(-w // TILE[1])


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on {device}; "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_strokes(samples, widths, colors, canvas_like):
    """Check the stroke tensors; returns N, P and the chunk size."""
    dev = samples.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA stroke kernels need CUDA tensors, got {dev}")
    if samples.dim() != 3 or samples.shape[2] != 2 or samples.shape[1] < 2:
        raise ValueError(f"samples must be (N, P >= 2, 2); got {tuple(samples.shape)}")
    n, p, _ = samples.shape
    chunk = chunk_size(p)
    _check("samples", samples, (n, p, 2), dev)
    _check("widths", widths, (n,), dev)
    _check("colors", colors, (n, 4), dev)
    if canvas_like.dim() != 3 or canvas_like.shape[0] != 4:
        raise ValueError(f"canvas tensors must be (4, H, W); got {tuple(canvas_like.shape)}")
    _check("canvas", canvas_like, tuple(canvas_like.shape), dev)
    return n, p, chunk


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def _ptr(t):
    return t.data_ptr() if t.numel() else None


def launch_fwd(samples, widths, colors, bg_premult, store: bool = False):
    """K4 (or K4s with ``store``): (N, P, 2) samples, (N,) widths, (N, 4)
    colors, (4, H, W) premultiplied background → (4, H, W) premultiplied
    canvas [, the ``TileState`` K5 takes]."""
    n, p, chunk = _check_strokes(samples, widths, colors, bg_premult)
    _, h, w = bg_premult.shape
    dev = samples.device
    lo, hi = (t.contiguous() for t in torch.aminmax(samples, dim=1))  # the samples' box (N, 2), one kernel
    out = torch.empty((4, h, w), dtype=torch.float32, device=dev)
    tiles = _tile_count(h, w)
    state = None
    if store:
        state = TileState(lo, hi, torch.empty((tiles,), dtype=torch.int32, device=dev),
                          torch.empty((tiles, n), dtype=torch.int32, device=dev),
                          torch.empty((tiles, -(-n // chunk), *CANVAS_SLOT), dtype=torch.float32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _library().strokes_fwd(_ptr(samples), _ptr(widths), _ptr(colors), _ptr(lo), _ptr(hi),
                                  bg_premult.data_ptr(), out.data_ptr(),
                                  *((state.counts.data_ptr(), _ptr(state.lists), _ptr(state.canvases)) if store
                                    else (None, None, None)),
                                  n, p, h, w, stream)
    _raise_on(code, "strokes_fwd")
    LAUNCHES["strokes_fwd_store" if store else "strokes_fwd"] += 1
    return (out, state) if store else out


def launch_bwd(g, samples, widths, colors, state: TileState):
    """K5: (4, H, W) cotangent of the premultiplied canvas and K4s's state →
    dsamples (N, P, 2), dmeta (N, 5) [dwidth, dr, dg, db, dalpha], dbg (4, H, W)."""
    n, p, chunk = _check_strokes(samples, widths, colors, g)
    _, h, w = g.shape
    dev = samples.device
    tiles = _tile_count(h, w)
    _check("lo", state.lo, (n, 2), dev)
    _check("hi", state.hi, (n, 2), dev)
    _check("counts", state.counts, (tiles,), dev, torch.int32)
    _check("lists", state.lists, (tiles, n), dev, torch.int32)
    _check("canvases", state.canvases, (tiles, -(-n // chunk), *CANVAS_SLOT), dev)
    dsamples = torch.zeros((n, p, 2), dtype=torch.float32, device=dev)
    dmeta = torch.zeros((n, 5), dtype=torch.float32, device=dev)
    dbg = torch.empty((4, h, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _library().strokes_bwd(g.data_ptr(), _ptr(samples), _ptr(widths), _ptr(colors), _ptr(state.lo),
                                  _ptr(state.hi), state.counts.data_ptr(), _ptr(state.lists),
                                  _ptr(state.canvases), _ptr(dsamples), _ptr(dmeta), dbg.data_ptr(),
                                  n, p, h, w, stream)
    _raise_on(code, "strokes_bwd")
    LAUNCHES["strokes_bwd"] += 1
    return dsamples, dmeta, dbg


class StrokesFunction(torch.autograd.Function):
    """K4s forward, K5 backward: (N, P, 2) samples, (N,) widths, (N, 4)
    colors, (4, H, W) premultiplied background → (4, H, W) premultiplied canvas."""

    @staticmethod
    def forward(ctx, samples, widths, colors, bg_premult):
        canvas, state = launch_fwd(samples, widths, colors, bg_premult, store=True)
        ctx.save_for_backward(samples, widths, colors, *state)
        return canvas

    @staticmethod
    def backward(ctx, g):
        samples, widths, colors, *state = ctx.saved_tensors
        dsamples, dmeta, dbg = launch_bwd(g.float().contiguous(), samples, widths, colors, TileState(*state))
        return dsamples, dmeta[:, 0], dmeta[:, 1:5], dbg


def render_premult(samples, widths, colors, bg_premult):
    """Paint strokes over a (4, H, W) premultiplied CUDA canvas with the kernels."""
    args = [t.float().contiguous() for t in (samples, widths, colors, bg_premult)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return StrokesFunction.apply(*args)
    return launch_fwd(*args)


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
