"""Fused multi-head attention for the CLIP and SLIP towers on Hopper.

``attention(qkv, heads, causal)`` takes the packed ``in_proj`` output (B,
T, 3D), q, k and v at column offsets 0, D and 2D, head h at h*hd in each,
and returns softmax(q k^T hd^-0.5) v as (B, T, D), ready for ``out_proj``.
Its backward gives the gradient of ``qkv`` as one (B, T, 3D) tensor.  It is
the counterpart of the JAX towers' default attention,
``jax.nn.dot_product_attention`` (``pixray_tpu/models/clip/model.py``); it
replaces no Pallas kernel.  The CUDA source is ``csrc/attention.cu``; it
says what bounds the kernels on the card and how.

Build: ``ops/nvcc.py`` (nvcc for ``sm_90a`` into ``_build/`` at first use,
loaded with ``ctypes``).  Nothing is built when this module is imported.

Dispatch: CUDA tensors launch the kernels (``attn_fwd_kernel``,
``attn_bwd_kernel``); CPU tensors take the plain version
(:func:`attention_fwd_plain`, :func:`attention_bwd_plain`), which does the
kernels' arithmetic: the scores summed and scaled in float32, the softmax
in float32 with its log-sum-exp (LSE) kept, the probabilities rounded to
the input's dtype only as the operand of PV, and in the backward P
recomputed from the LSE, dP and dS = P (dP - rowsum(dO O)) in float32, dS
rounded only as the operand of the dq and dk products.  There is no
fallback: a CUDA tensor launches the kernel or raises.  The kernels take
bf16 at head dims 32 and 64.

``LAUNCHES`` counts kernel launches ("attn_fwd", "attn_bwd"), so a run can
show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from pixray_tpu_torch.ops.nvcc import build_library, library_path, source_path

SOURCE = source_path("attention.cu")
LIBRARY = library_path("libpixray_attention.so")

HEAD_DIMS = (32, 64)  # as csrc/attention.cu instantiates its kernels
LAUNCHES = {"attn_fwd": 0, "attn_bwd": 0}
# the kernels' names (the profiler's), by counter
KERNEL_NAMES = {"attn_fwd": "attn_fwd_kernel", "attn_bwd": "attn_bwd_kernel"}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build(force: bool = False) -> str:
    """Compile ``csrc/attention.cu`` if the library is missing or older than it."""
    return build_library(SOURCE, LIBRARY, force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.attn_fwd.argtypes = [ptr, ptr, ptr] + [i32] * 5 + [f32, ptr]
            lib.attn_bwd.argtypes = [ptr] * 5 + [i32] * 5 + [f32, ptr]
            lib.attn_max_tokens.argtypes = [i32]
            for fn in (lib.attn_fwd, lib.attn_bwd, lib.attn_max_tokens):
                fn.restype = i32
            _lib = lib
        return _lib


@functools.cache
def max_tokens(hd: int) -> int:
    """The longest sequence the kernels take at head dim ``hd`` (builds the library)."""
    return _library().attn_max_tokens(hd)


def _shape(qkv, heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, T, 3 * heads * hd); got {tuple(qkv.shape)} with {heads} heads")
    b, t, d3 = qkv.shape
    return b, t, d3 // 3, d3 // (3 * heads)


# ------------------------------------------------------------------ plain version
def _split(x, heads: int, n: int):
    """(B, T, n * D) → n float32 (B, heads, T, D / heads) tensors."""
    b, t, width = x.shape
    d = width // n
    return [z.reshape(b, t, heads, d // heads).transpose(1, 2).float() for z in x.split(d, dim=-1)]


def _scores(q, k, hd: int, causal: bool):
    """q k^T * hd^-0.5 in float32, -inf on a key after its query under ``causal``."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=s.device).tril(), float("-inf"))
    return s


def _merge(x):
    """(B, heads, T, hd) → (B, T, heads * hd)."""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attention_fwd_plain(qkv, heads: int, causal: bool = False):
    """The plain forward: (O (B, T, D) in ``qkv``'s dtype, LSE (B, heads, T) float32)."""
    _, _, _, hd = _shape(qkv, heads)
    q, k, v = _split(qkv, heads, 3)
    s = _scores(q, k, hd, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(qkv.dtype).float()
    return _merge(torch.matmul(p, v)).to(qkv.dtype), lse


def attention_bwd_plain(qkv, out, lse, dout, heads: int, causal: bool = False):
    """The plain backward: dqkv (B, T, 3D) in ``qkv``'s dtype from the
    forward's ``out`` and ``lse`` and the cotangent ``dout`` (B, T, D)."""
    _, _, _, hd = _shape(qkv, heads)
    q, k, v = _split(qkv, heads, 3)
    do, o = _split(dout, heads, 1)[0], _split(out, heads, 1)[0]
    p = torch.exp(_scores(q, k, hd, causal) - lse[..., None])
    delta = (do * o).sum(-1, keepdim=True)
    ds = (p * (torch.matmul(do, v.transpose(-1, -2)) - delta)).to(qkv.dtype).float()
    dq = torch.matmul(ds, k) * (hd ** -0.5)
    dk = torch.matmul(ds.transpose(-1, -2), q) * (hd ** -0.5)
    dv = torch.matmul(p.to(qkv.dtype).float().transpose(-1, -2), do)
    return torch.cat([_merge(g) for g in (dq, dk, dv)], dim=-1).to(qkv.dtype)


# ------------------------------------------------------------------ launchers
def _check(name, t, dev, shape):
    if (t.device != dev or t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned bfloat16 {tuple(shape)} tensor on {dev}; "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_sizes(qkv, heads: int):
    b, t, d, hd = _shape(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"the CUDA attention kernels need CUDA tensors, got {qkv.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the attention kernels take head dims {HEAD_DIMS}; got {hd}")
    if t > max_tokens(hd) or b * heads > 65535:
        raise ValueError(f"the attention kernels take at most {max_tokens(hd)} tokens and 65535 (batch, head) "
                         f"pairs; got {t} tokens, {b} x {heads}")
    _check("qkv", qkv, qkv.device, (b, t, 3 * d))
    return b, t, d, hd


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def launch_fwd(qkv, heads: int, causal: bool = False):
    """``attn_fwd_kernel``: (B, T, 3D) bf16 on the card → (O (B, T, D) bf16, LSE (B, heads, T) f32)."""
    b, t, d, hd = _check_sizes(qkv, heads)
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _raise_on(_library().attn_fwd(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, heads, hd, int(causal),
                                  hd ** -0.5, stream), "attn_fwd")
    LAUNCHES["attn_fwd"] += 1
    return out, lse


def launch_bwd(qkv, out, lse, dout, heads: int, causal: bool = False):
    """``attn_bwd_kernel``: the forward's inputs and outputs and the cotangent (B, T, D) bf16 → dqkv (B, T, 3D) bf16."""
    b, t, d, hd = _check_sizes(qkv, heads)
    for name, x in (("out", out), ("dout", dout)):
        _check(name, x, qkv.device, (b, t, d))
    if lse.device != qkv.device or lse.dtype != torch.float32 or lse.shape != (b, heads, t) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, heads, t)} tensor on {qkv.device}")
    dqkv = torch.empty_like(qkv)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _raise_on(_library().attn_bwd(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dqkv.data_ptr(),
                                  b, t, heads, hd, int(causal), hd ** -0.5, stream), "attn_bwd")
    LAUNCHES["attn_bwd"] += 1
    return dqkv


class AttentionFunction(torch.autograd.Function):
    """The kernels on the card, the plain version on the CPU; the gradient flows to ``qkv``."""

    @staticmethod
    def forward(ctx, qkv, heads, causal):
        fwd = launch_fwd if qkv.device.type == "cuda" else attention_fwd_plain
        out, lse = fwd(qkv, heads, causal)
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.causal = heads, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        if qkv.device.type == "cuda":
            return launch_bwd(qkv, out, lse, dout.to(qkv.dtype).contiguous(), ctx.heads, ctx.causal), None, None
        return attention_bwd_plain(qkv, out, lse, dout, ctx.heads, ctx.causal), None, None


def attention(qkv, heads: int, causal: bool = False):
    """softmax(q k^T hd^-0.5) v of the packed (B, T, 3D) ``qkv`` as (B, T, D).

    CUDA tensors go through the kernels (bf16, head dim 32 or 64); CPU
    tensors through the plain version, in any float dtype."""
    _shape(qkv, heads)
    if qkv.device.type == "cuda":
        return AttentionFunction.apply(qkv.contiguous(), heads, causal)
    if qkv.device.type == "cpu":
        return AttentionFunction.apply(qkv, heads, causal)
    raise ValueError(f"unsupported device for attention: {qkv.device}")
