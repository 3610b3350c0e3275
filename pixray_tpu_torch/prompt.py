"""Prompt string parsing: ``"text:weight:stop"`` triples.

Same grammar as ``pixray_tpu/prompt.py``: numbers are peeled off the
right-hand side; one number is a weight, two are (stop, weight) with the
rightmost number the weight.
"""

from __future__ import annotations


def is_number(s) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def parse_prompt(prompt: str):
    """Split a prompt into (text, weight, stop)."""
    text = prompt
    weight = 1.0
    stop = float("-inf")

    extra_numbers: list[float] = []
    while len(extra_numbers) < 2:
        vals = text.rsplit(":", 1)
        if len(vals) > 1 and is_number(vals[1]):
            extra_numbers.append(float(vals[1]))
            text = vals[0]
        else:
            break

    if len(extra_numbers) == 1:
        weight = extra_numbers[0]
    elif len(extra_numbers) == 2:
        weight = extra_numbers[1]
        stop = extra_numbers[0]

    return text, weight, stop
