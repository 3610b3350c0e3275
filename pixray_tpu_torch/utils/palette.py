"""Palette DSL (a copy of ``pixray_tpu/utils/palette.py``, which
``tests/test_torch_palette.py`` holds it equal to).

- named colours (xkcd first, ``mat:`` prefix for matplotlib's CSS4, base
  and tableau names), resolved from the checked-in tables of
  ``utils/color_names.py``, so matplotlib is not needed;
- special pixel-art names (``pixel_green`` etc.);
- ``(255,0,0)`` / ``[1,0,0]`` literal triples (``+``-separated components);
- ``a->b->c`` ramps, ``\\N`` step-count suffixes, bare colour = black->colour ramp;
- ``[a, b, c]`` explicit lists (optionally ``\\N``-resampled);
- ``;``-concatenated sections;
- ``@file.png`` / ``@file.act`` palette extraction (PIL, imported only there).
"""

from __future__ import annotations

import re
from codecs import encode

from .color_names import BASE_COLORS, CSS4_COLORS, TABLEAU_COLORS, XKCD_COLORS
from .files import map_number

_PIXEL_PALETTE = {
    "pixel_green": [0.44, 1.00, 0.53],
    "pixel_orange": [1.00, 0.80, 0.20],
    "pixel_blue": [0.44, 0.53, 1.00],
    "pixel_red": [1.00, 0.53, 0.44],
    "pixel_grayscale": [1.00, 1.00, 1.00],
}

# matplotlib's name map, built in its order of priority (matplotlib/colors.py)
_NAMED = {}
_NAMED.update(XKCD_COLORS)
_NAMED.update({k.replace("grey", "gray"): v for k, v in XKCD_COLORS.items() if "grey" in k})
_NAMED.update(CSS4_COLORS)
_NAMED.update(TABLEAU_COLORS)
_NAMED.update({k.replace("gray", "grey"): v for k, v in TABLEAU_COLORS.items() if "gray" in k})
_NAMED.update(BASE_COLORS)
_CYCLE = list(TABLEAU_COLORS.values())  # matplotlib's default property cycle, "C0".."C9"


def to_rgb(c: str) -> tuple:
    """``matplotlib.colors.to_rgb`` of a string: a name, ``#rgb[a]`` /
    ``#rrggbb[aa]`` hex, a gray level in [0, 1] or ``C<n>``; ValueError
    otherwise."""
    orig = c
    if re.match(r"\AC[0-9]+\Z", c):
        c = _CYCLE[int(c[1:]) % len(_CYCLE)]
    if c.lower() == "none":
        return (0.0, 0.0, 0.0)
    if c in _NAMED:
        c = _NAMED[c]
    elif len(c) != 1 and c.lower() in _NAMED:
        c = _NAMED[c.lower()]
    if not isinstance(c, str):
        return tuple(float(v) for v in c)
    for digits, step in ((6, 2), (3, 1), (8, 2), (4, 1)):
        if re.match(r"\A#[a-fA-F0-9]{%d}\Z" % digits, c):
            return tuple(int(c[1 + i * step:1 + (i + 1) * step] * (3 - step), 16) / 255 for i in range(3))
    try:
        gray = float(c)
    except ValueError:
        raise ValueError(f"Invalid RGBA argument: {orig!r}") from None
    if not 0 <= gray <= 1:
        raise ValueError(f"Invalid string grayscale value {orig!r}. Value must be within 0-1 range")
    return (gray, gray, gray)


def is_color_like(c: str) -> bool:
    try:
        to_rgb(c)
    except ValueError:
        return False
    return True


def parse_triple_to_rgb(s: str) -> list[float]:
    """Parse ``(255,255,0)`` (0-255) or ``[1,1,0]`` (0-1) literals; components
    separated by ``+`` or ``,``."""
    body = re.sub(r"[(\[\])]", "", s)
    parts = re.split(r"[+,]", body)
    rgb = [float(n) for n in parts]
    if s[0] == "(":
        rgb = [n / 255.0 for n in rgb]
    return rgb


def get_single_rgb(s: str):
    """Resolve one color token to an RGB triple in [0,1]."""
    if s[0] == "(" or s[0] == "[":
        return parse_triple_to_rgb(s)
    if s in _PIXEL_PALETTE:
        return _PIXEL_PALETTE[s]
    if s[:4] == "mat:":
        return list(to_rgb(s[4:]))
    if is_color_like(f"xkcd:{s}"):
        return list(to_rgb(f"xkcd:{s}"))
    return list(to_rgb(s))


def expand_colors(colors, num_steps: int):
    """Piecewise-linear resample of a color list to ``num_steps`` entries."""
    eps = 1e-6
    pal = []
    num_colors = len(colors)
    for n in range(num_steps):
        f = map_number(n, 0, num_steps - 1, 0, num_colors - 1) if num_steps > 1 else 0.0
        i = int(f)
        off = f - i
        if off < eps or (1.0 - off) < eps:
            pal.append(list(colors[i]))
        else:
            c1, c2 = colors[i], colors[i + 1]
            pal.append([map_number(off, 0, 1, c1[k], c2[k]) for k in range(3)])
    return pal


def _split_steps(s: str, default=None):
    """Split an optional ``\\N`` step-count suffix off a section."""
    if s.find("\\") > 0:
        stem, steps = s.split("\\")
        return stem, int(steps)
    return s, default


def get_rgb_range(s: str):
    """``a->b->c`` ramp (or bare color = black->color), default 16 steps."""
    parts = s.split("->") if s.find("->") > 0 else ["black", s]
    parts[-1], num_steps = _split_steps(parts[-1], 16)
    colors = [get_single_rgb(p) for p in parts]
    return expand_colors(colors, num_steps)


def _palette_from_image(path: str, num_steps):
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if num_steps is None:
        num_steps = 255
    color_pairs = img.getcolors(img.size[0] * img.size[1])
    if color_pairs is not None and len(color_pairs) <= num_steps:
        return [[c[1][0] / 255.0, c[1][1] / 255.0, c[1][2] / 255.0] for c in color_pairs]
    quantized = img.quantize(colors=num_steps, method=Image.Quantize.MEDIANCUT)
    raw = quantized.getpalette()[: num_steps * 3]
    return [[raw[i] / 255.0, raw[i + 1] / 255.0, raw[i + 2] / 255.0] for i in range(0, len(raw), 3)]


def _palette_from_act(path: str):
    """Photoshop .act palette file."""
    with open(path, "rb") as act:
        raw_data = act.read()
    hex_data = encode(raw_data, "hex")
    total_colors_count = int(hex_data[-7:-4], 16)
    colors = [hex_data[i : i + 6].decode() for i in range(0, total_colors_count * 6, 6)]
    colors = ["#" + c for c in colors if len(c)]
    return [get_single_rgb(c) for c in colors]


def palette_from_section(s: str):
    """Parse one ``;``-delimited palette section."""
    s = s.strip()
    if s[0] == "[":
        stem, num_steps = _split_steps(s)
        chunks = stem[1:-1].split(",")
        pal = [get_single_rgb(c.strip()) for c in chunks]
        if num_steps is not None:
            pal = expand_colors(pal, num_steps)
        return pal
    if s[0] == "@" or s[:4] == "http":
        stem, num_steps = _split_steps(s)
        path = stem[1:] if stem[0] == "@" else stem
        if stem.endswith((".png", ".jpg", ".gif")):
            return _palette_from_image(path, num_steps)
        if stem.endswith(".act"):
            return _palette_from_act(path)
        raise ValueError(f"Unknown file type: {s}")
    return get_rgb_range(s)


def palette_from_string(s: str):
    """Parse a full palette string: ``;``-concatenated sections."""
    pal = []
    for chunk in s.strip().split(";"):
        pal = pal + palette_from_section(chunk)
    return pal
