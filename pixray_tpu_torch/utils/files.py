"""File/path/unit utilities (same semantics as ``pixray_tpu.utils.files``).

Brace-expanded globs, validated output paths, argparse bools, the
``'50%'``/``'20 iterations'`` unit parser, pipe splitting, and
``%DATE%``/``%SEQ%`` filename templating.  Pure Python.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import itertools
import os
import re
from pathlib import Path


def brace_expand(pattern: str) -> list[str]:
    """Expand shell-style ``{a,b}`` alternations in a glob pattern (nesting ok,
    no numeric ranges)."""
    start = pattern.find("{")
    if start < 0:
        return [pattern]
    depth = 0
    alts, buf = [], []
    for i in range(start, len(pattern)):
        c = pattern[i]
        if c == "{":
            depth += 1
            if depth == 1:
                continue
        elif c == "}":
            depth -= 1
            if depth == 0:
                alts.append("".join(buf))
                head, tail = pattern[:start], pattern[i + 1 :]
                out: list[str] = []
                for alt in alts:
                    out.extend(brace_expand(head + alt + tail))
                return out
        elif c == "," and depth == 1:
            alts.append("".join(buf))
            buf = []
            continue
        buf.append(c)
    return [pattern]  # unbalanced braces: treat literally


def real_glob(rglob: str) -> list[str]:
    """Brace-expanded glob returning a sorted file list."""
    files = list(itertools.chain.from_iterable(glob.glob(g) for g in brace_expand(rglob)))
    return sorted(files)


def get_file_path(directory: str, filename: str | None, suffix: str) -> str:
    """Join directory+filename with a forced suffix; path-y or empty filenames raise."""
    if filename is None or re.search(r"\\|/|^$", filename.strip()):
        raise ValueError("Invalid filename specified.")
    return str(Path(directory, filename).with_suffix(suffix))


def str2bool(v) -> bool:
    """argparse-friendly bool parser."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def parse_unit(value, total_iterations: int, argument_name: str, default_unit: str = "%"):
    """Parse ``'30'``/``'30i'``/``'10%'``-style values into an iteration count."""
    if value is None:
        return None

    value = str(value).lower().strip()
    digits = re.search(r"^\d*[.]?\d+", value)

    if re.match(r"^\d*[.]?\d+$", value):
        value += default_unit

    if re.match(r"^\d*[.]?\d+[\s]*(i|iter|iterations)$", value):
        return int(float(digits.group(0)))
    if re.match(r"^\d*[.]?\d+[\s]*(p|%|percent)$", value):
        return int(float(digits.group(0)) * 0.01 * total_iterations)

    raise ValueError(
        f"Invalid value for {argument_name}, please use a digit-unit combination "
        "like '20 iterations' or '50%'."
    )


def split_pipes(attribute):
    """Split a ``|``-separated multi-prompt string."""
    if not attribute:
        return attribute
    return [phrase.strip() for phrase in attribute.split("|")]


def emit_filename(filename: str, template_dict: dict | None = None) -> str:
    """Fill ``%DATE%``, ``%SEQ%`` and custom ``%KEY%`` placeholders in a filename."""
    datestr = datetime.datetime.now().strftime("%Y%m%d")
    filename = filename.replace("%DATE%", datestr)

    for key, val in (template_dict or {}).items():
        filename = filename.replace(f"%{key}%", f"{val}")

    if "%SEQ%" in filename:
        cur_seq = 1
        candidate = filename.replace("%SEQ%", f"{cur_seq:02d}")
        while os.path.exists(candidate):
            cur_seq += 1
            candidate = filename.replace("%SEQ%", f"{cur_seq:02d}")
        filename = candidate
    return filename


def map_number(n, start1, stop1, start2, stop2):
    """Linear range remap (p5.js ``map``)."""
    return ((n - start1) / (stop1 - start1)) * (stop2 - start2) + start2


def find_model_file(names) -> str | None:
    """The first of the file ``names`` found in ``$PIXRAY_TPU_MODELS``,
    ``models/`` or ``~/.cache/pixray_tpu`` (in that order), else None.
    Nothing is downloaded."""
    for d in (os.environ.get("PIXRAY_TPU_MODELS", ""), "models", os.path.expanduser("~/.cache/pixray_tpu")):
        if not d:
            continue
        for name in names:
            path = os.path.join(d, name)
            if os.path.exists(path):
                return path
    return None
