"""Host-side image IO: loading, Lanczos resizing, array conversion, spot
masks (port of ``pixray_tpu/io/images.py``).

These run at init and at host events only (the init and overlay images,
image prompts and labels, target images, spot masks); the step never
touches PIL.  PIL is imported inside each function that needs it, so a
run without images imports none.  Images travel as (H, W, C) float32
numpy arrays in [0, 1].
"""

from __future__ import annotations

import os

import numpy as np

from pixray_tpu_torch.utils import real_glob

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "inputs")


def open_image(path_or_url: str):
    from PIL import Image

    if "http" in str(path_or_url):
        from urllib.request import urlopen

        return Image.open(urlopen(path_or_url))
    return Image.open(path_or_url)


def open_images(spec: str) -> list:
    """One URL, or every file of a brace-glob (the init and overlay images)."""
    if "http" in spec:
        return [open_image(spec)]
    return [open_image(f) for f in real_glob(spec)]


def to_tensor(img) -> np.ndarray:
    """PIL → (H, W, C) float32 in [0, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def from_tensor(arr):
    """(H, W, C) float in [0, 1] → PIL (RGBA for four channels), truncating ``* 255.999``."""
    from PIL import Image

    arr = np.asarray(arr)
    mode = "RGBA" if arr.shape[-1] == 4 else "RGB"
    return Image.fromarray((np.clip(arr, 0, 1) * 255.999).astype(np.uint8), mode)


def resize_area_preserving(image, out_size):
    """Aspect-preserving resize to at most the area of ``out_size`` (w, h)."""
    from PIL import Image

    ratio = image.size[0] / image.size[1]
    area = min(image.size[0] * image.size[1], out_size[0] * out_size[1])
    size = round((area * ratio) ** 0.5), round((area / ratio) ** 0.5)
    return image.resize(size, Image.LANCZOS)


def resize_bicubic(image, size_wh) -> np.ndarray:
    """A PIL image as RGB at ``size_wh`` (w, h), bicubic, → (H, W, 3) float32 in [0, 1] (the style image)."""
    from PIL import Image

    return to_tensor(image.convert("RGB").resize(size_wh, Image.BICUBIC))


def load_image_rgb(path: str, size_wh) -> np.ndarray:
    from PIL import Image

    return to_tensor(open_image(path).convert("RGB").resize(size_wh, Image.LANCZOS))


def load_image_for_perceptor(path: str, resolution: int) -> np.ndarray:
    """(S, S, 3): the shorter side resized to ``resolution`` (bicubic), then the centre crop."""
    from PIL import Image

    img = open_image(path).convert("RGB")
    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - resolution) // 2, (h - resolution) // 2
    return to_tensor(img.crop((left, top, left + resolution, top + resolution)))


def default_spot_mask(size: int, aspect: float) -> np.ndarray:
    """Procedural spot mask: 1 (white) on the background ring, 0 on the
    centred subject ellipse.  Spot prompts zero the white region, so they
    score the subject; spot_off prompts score the ring."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = cy = (size - 1) / 2
    rx = size * (0.42 if aspect <= 1 else 0.48)
    ry = size * 0.36
    subject = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1.0
    return 1.0 - subject.astype(np.float32)


def builtin_spot_asset(aspect: float):
    """The package's mask (``assets/inputs/spot_{square,wide}.png``, by
    aspect), or None where the file is missing."""
    path = os.path.join(ASSETS, "spot_square.png" if aspect <= 1.1 else "spot_wide.png")
    return path if os.path.exists(path) else None


def load_spot_mask(spot_file, size: int, aspect: float) -> np.ndarray:
    """(size, size) float32 mask: 1 where the image is at least half white."""
    from PIL import Image

    if spot_file is None:
        spot_file = builtin_spot_asset(aspect)
    if spot_file is None:
        return default_spot_mask(size, aspect)
    img = open_image(spot_file).convert("L").resize((size, size), Image.LANCZOS)
    return (np.asarray(img, dtype=np.float32) / 255.0 >= 0.5).astype(np.float32)
