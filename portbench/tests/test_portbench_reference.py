"""The plain reference against the program's plain CPU path at a tiny
size, and the judge against runs broken underneath.

The tiny cells run the whole of a run but the search for a card: the
engine on the CPU (float32 towers, a block as its steps in a loop), the
window, the reference followed from the seed, the judge.  The sound
program agrees with the reference to float32 rounding; a step that keeps
its state, a tower that sees half its cutouts, and the program's own int8
rungs (the control, with bf16 towers) each come out not correct."""

from __future__ import annotations

import time

import pytest
import torch
from conftest_tiny import tiny_checkout
from readings import CONTROL_RUNGS, environment, half_batch, unchanged_steps

from portbench.harness import cell as C
from portbench.harness.measure import measure

SEED = 2200000123  # more than 31 bits: seeds of that size must work


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def run(checkout, name, **program):
    cell = C.load(name, *checkout)
    cell.config["program"].update(program)
    return measure(cell, SEED, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["tiny.pixel", "tiny.vqgan"])
def test_reference_matches_the_plain_path(checkout, name):
    result, lines = run(checkout, name)
    assert result["correct"], lines
    for check in result["checks"].values():
        assert check["value"] < 1e-4  # float32 rounding
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"steps_per_s", "setup_s"}
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", ["tiny.pixel", "tiny.vqgan"])
@pytest.mark.parametrize("fault", [unchanged_steps, half_batch])
def test_a_broken_step_is_not_correct(checkout, name, fault):
    with fault():
        result, lines = run(checkout, name)
    assert not result["correct"], lines


@pytest.mark.parametrize("name", ["tiny.pixel", "tiny.vqgan"])
def test_the_control_is_not_correct(checkout, name):
    with environment(CONTROL_RUNGS):
        result, lines = run(checkout, name, precision="bf16")
    assert not result["correct"], lines
