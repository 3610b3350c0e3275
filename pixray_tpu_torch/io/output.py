"""Checkin PNG with ``pixray_*`` provenance text chunks, written with zlib + struct.

The same metadata as ``pixray_tpu/utils/provenance.py`` (``Software``, one
``pixray_<setting>`` chunk per non-default setting, ``pixray_seed_used``),
without PIL: the card's machine has no image library to rely on.
"""

from __future__ import annotations

import os
import struct
import subprocess
import zlib
from functools import lru_cache

import numpy as np

FALLBACK_VERSION = "v0.1.0+torch"


@lru_cache(maxsize=1)
def framework_version() -> str:
    """``git describe`` of the checkout, or a fixed fallback outside a git tree."""
    try:
        env = {k: v for k in ("SYSTEMROOT", "PATH") if (v := os.environ.get(k))}
        env.update({"LANGUAGE": "C", "LANG": "C", "LC_ALL": "C"})
        out = subprocess.run(
            ["git", "describe", "--always"], capture_output=True, env=env, timeout=10,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ).stdout.strip().decode("ascii", errors="replace")
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or FALLBACK_VERSION


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _text_chunk(key: str, value: str) -> bytes:
    try:
        return _chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1"))
    except UnicodeEncodeError:  # iTXt: uncompressed UTF-8, no language tag
        return _chunk(b"iTXt", key.encode("latin-1") + b"\0\0\0\0\0" + value.encode("utf-8"))


def png_text(given_args: dict, seed_used) -> list[tuple[str, str]]:
    text = [("Software", f"pixray_tpu_torch ({framework_version()})")]
    text += [(f"pixray_{k}", str(v)) for k, v in given_args.items()]
    text.append(("pixray_seed_used", str(seed_used)))
    return text


def encode_png(pixels: np.ndarray, text=()) -> bytes:
    """(H, W, 3|4) uint8 → PNG bytes (8-bit RGB/RGBA, no filtering)."""
    h, w, c = pixels.shape
    color_type = {3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))]
    out += [_text_chunk(k, v) for k, v in text]
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def to_uint8(arr) -> np.ndarray:
    """(H, W, C) float in [0, 1] → uint8, as the JAX package's ``from_tensor``."""
    return (np.clip(np.asarray(arr), 0, 1) * 255.999).astype(np.uint8)


def save_png(arr, outfile: str, text=()):
    """(H, W, C) float image in [0, 1] → PNG file with optional text chunks."""
    with open(outfile, "wb") as f:
        f.write(encode_png(to_uint8(arr), text))
