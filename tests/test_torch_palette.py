"""The palette DSL of the port against the JAX package's, and its checked-in
colour tables against matplotlib's (the GPU machine has no matplotlib).

- Every table entry equal to matplotlib's, and every name of matplotlib's
  full map (xkcd, CSS4, tableau, base, their gray/grey spellings)
  resolving to ``matplotlib.colors.to_rgb``'s triple exactly, through
  ``to_rgb``, ``get_single_rgb`` and its ``mat:`` prefix.
- ``palette_from_string`` equal (exact floats) to the JAX package's on
  ``tests/test_palette.py``'s strings, ramps, ``\\N`` steps, ``;``
  sections, hex and gray tokens, and a ``@file.png`` and ``@file.act``
  the test writes.
"""

import matplotlib.colors as mcolors
import pytest

from pixray_tpu.utils import get_single_rgb as j_get_single_rgb
from pixray_tpu.utils import palette_from_string as j_palette_from_string
from pixray_tpu_torch.utils import color_names
from pixray_tpu_torch.utils.palette import get_single_rgb, is_color_like, palette_from_string, to_rgb


def test_tables_equal_matplotlib():
    assert color_names.XKCD_COLORS == dict(mcolors.XKCD_COLORS)
    assert color_names.CSS4_COLORS == dict(mcolors.CSS4_COLORS)
    assert color_names.TABLEAU_COLORS == dict(mcolors.TABLEAU_COLORS)
    assert color_names.BASE_COLORS == dict(mcolors.BASE_COLORS)
    assert len(color_names.XKCD_COLORS) == 949 and len(color_names.CSS4_COLORS) == 148


def test_every_name_resolves_like_matplotlib():
    names = list(mcolors.get_named_colors_mapping())
    assert len(names) > 1100
    for name in names:
        assert to_rgb(name) == mcolors.to_rgb(name), name
        assert get_single_rgb(f"mat:{name}") == j_get_single_rgb(f"mat:{name}"), name
    for name in list(mcolors.XKCD_COLORS)[::7] + list(mcolors.CSS4_COLORS):
        bare = name[5:] if name.startswith("xkcd:") else name
        assert get_single_rgb(bare) == j_get_single_rgb(bare), bare


@pytest.mark.parametrize("token", ["#abc", "#ABCDEF", "#a1b2c3d4", "#abcd", "0.25", "1", "C0", "C13", "none",
                                   "Red", "DarkBlue", "tab:grey", "light grey", "(255,128,0)", "[1+0.5+0]",
                                   "pixel_green", "mat:k", "mat:0.5"])
def test_tokens_resolve_like_jax(token):
    assert get_single_rgb(token) == j_get_single_rgb(token)


@pytest.mark.parametrize("token", ["notacolor", "#12345", "1.5", "mat:xkcd:notacolor"])
def test_bad_tokens_raise_like_jax(token):
    with pytest.raises(ValueError):
        j_get_single_rgb(token)
    with pytest.raises(ValueError):
        get_single_rgb(token)
    assert not is_color_like(token)


@pytest.mark.parametrize("spec", [
    "white", "red\\8", "mat:black->mat:white\\3", "[mat:black, mat:red, mat:white]", "red\\8;blue->yellow\\8",
    "[mat:black, mat:white]\\6", "black->red->(0,0,255)->[0+1+0]\\11", "pixel_green\\5", "sky blue->#ffcc00",
    "[0.5, C3, tab:olive]\\2", "red\\1", "mat:red->mat:blue\\2; white ;[black]",
])
def test_palette_strings_match_jax(spec):
    assert palette_from_string(spec) == j_palette_from_string(spec)


def test_file_palettes_match_jax(tmp_path):
    from PIL import Image

    two = Image.new("RGB", (8, 8), (255, 0, 0))
    two.paste((0, 64, 255), (0, 0, 4, 8))
    two.save(tmp_path / "two.png")
    many = Image.new("RGB", (16, 16))
    many.putdata([((i * 37) % 256, (i * 11) % 256, (i * 5) % 256) for i in range(256)])
    many.save(tmp_path / "many.png")
    body = bytes([255, 0, 0, 0, 255, 0, 10, 20, 30] + [0] * (768 - 9))
    (tmp_path / "pal.act").write_bytes(body + (3).to_bytes(2, "big") + (0).to_bytes(2, "big"))
    for spec in (f"@{tmp_path / 'two.png'}", f"@{tmp_path / 'many.png'}\\8", f"@{tmp_path / 'many.png'}",
                 f"@{tmp_path / 'pal.act'}", f"red\\2;@{tmp_path / 'two.png'}"):
        assert palette_from_string(spec) == j_palette_from_string(spec), spec
    assert len(palette_from_string(f"@{tmp_path / 'many.png'}\\8")) == 8
