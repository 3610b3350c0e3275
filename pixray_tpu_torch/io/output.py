"""Checkin PNG with ``pixray_*`` provenance text chunks, written with zlib +
struct, the step video of the checkin frames, the per-step video of
``--make_video`` and the animation's GIF (port of
``pixray_tpu/io/output.py``'s ``step_to_video``, ``do_video``,
``encode_frames_to_mp4`` and ``make_gif``).

The PNG carries the same metadata as ``pixray_tpu/utils/provenance.py``
(``Software``, one ``pixray_<setting>`` chunk per non-default setting,
``pixray_seed_used``), without PIL: the main path needs no image library.
The video tries the JAX package's backends in its order: the ``ffmpeg``
binary on PATH (fed the frames' PNG files), then ``imageio`` if it imports
and can write the MP4, else a GIF with the same warning, through PIL,
imported only there.  ``make_gif`` runs ffmpeg where it is on PATH, else
PIL, as the JAX package does.
"""

from __future__ import annotations

import glob
import os
import shutil
import struct
import subprocess
import zlib
from functools import lru_cache

import numpy as np

from pixray_tpu_torch.utils import get_file_path

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


def _clip_fps(total_frames: int, length_s: int = 14, min_fps: int = 10, max_fps: int = 60) -> int:
    return int(np.clip(total_frames / length_s, min_fps, max_fps))


def encode_frames_to_mp4(frame_paths: list[str], output_file: str, fps: int, comment: str = "") -> bool:
    """PNG frames → H.264 MP4 (the last frame held for a second), or a GIF
    beside it with a warning when no MP4 encoder is available.  True when
    the MP4 was written."""
    held = list(frame_paths) + [frame_paths[-1]] * fps
    if shutil.which("ffmpeg") is not None:
        cmd = ["ffmpeg", "-y", "-f", "image2pipe", "-vcodec", "png", "-r", str(fps),
               "-i", "-", "-vcodec", "libx264", "-r", str(fps), "-pix_fmt", "yuv420p",
               "-crf", "17", "-preset", "veryslow"]
        if comment:
            cmd += ["-metadata", f"comment={comment}"]
        cmd.append(output_file)
        p = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        for path in held:
            with open(path, "rb") as f:
                p.stdin.write(f.read())
        p.stdin.close()
        p.wait()
        return True
    try:
        import imageio

        read = getattr(imageio, "v2", imageio).imread
        with imageio.get_writer(output_file, fps=fps) as writer:
            for path in held:
                writer.append_data(np.asarray(read(path))[..., :3])
        return True
    except Exception as e:  # no encoder available: degrade to a GIF
        gif_file = os.path.splitext(output_file)[0] + ".gif"
        print(f"WARNING: no MP4 encoder available ({e}); writing {gif_file} instead")
    try:
        from PIL import Image
    except ImportError as e:
        print(f"WARNING: no GIF encoder either ({e}); no step video written")
        return False
    frames = [Image.open(path) for path in frame_paths]
    frames[0].save(gif_file, save_all=True, append_images=frames[1:], duration=int(1000 / fps), loop=0)
    return False


def step_to_video(args):
    """Checkin frames ``steps/frame_*.png`` → ``steps/output.mp4`` (or the GIF)."""
    step_folder = os.path.join(args.outdir, "steps")
    frame_paths = sorted(glob.glob(os.path.join(step_folder, "frame_*.png")))
    if not frame_paths:
        return
    encode_frames_to_mp4(frame_paths, os.path.join(step_folder, "output.mp4"), _clip_fps(len(frame_paths)))


def do_video(args, last_iteration: int):
    """``--make_video``'s per-step frames ``video/frame_NNNN.png`` (1 to
    ``last_iteration`` - 1) → ``<output>.mp4`` in the outdir (or the GIF)."""
    video_folder = os.path.join(args.outdir, "video")
    frame_paths = [os.path.join(video_folder, f"frame_{i:04d}.png") for i in range(1, last_iteration)]
    if not frame_paths:
        return
    output_file = get_file_path(args.outdir, args.output, ".mp4")
    encode_frames_to_mp4(frame_paths, output_file, _clip_fps(len(frame_paths)), comment=str(args.prompts))


def make_gif(animation_dir: str, fps: int = 10) -> str:
    """The animation's frame PNGs ``animation_dir/*.png`` → ``anim.gif`` there."""
    gif_output = os.path.join(animation_dir, "anim.gif")
    if os.path.exists(gif_output):
        os.remove(gif_output)
    frames = sorted(glob.glob(os.path.join(animation_dir, "*.png")))
    if not frames:
        return gif_output
    if shutil.which("ffmpeg") is not None:
        cmd = ["ffmpeg", "-framerate", str(fps), "-pattern_type", "glob",
               "-i", f"{animation_dir}/*.png", "-loop", "0", gif_output]
        try:
            subprocess.check_output(cmd)
        except subprocess.CalledProcessError as cpe:
            print("Ignoring non-zero exit: ", cpe.output)
    else:
        from PIL import Image

        images = [Image.open(f).convert("RGB") for f in frames]
        images[0].save(gif_output, save_all=True, append_images=images[1:], duration=int(1000 / fps), loop=0)
    return gif_output
