"""The plain reference against the program's plain CPU path at a tiny
size, and the judge against runs broken underneath.

The tiny cells run the whole of a run but the search for a card: the
engine on the CPU (float32 towers, a block as its steps in a loop), the
window, the reference followed from the seed (``tiny.run``: from the
program's latent, its noise init encoded, with a vector prompt, at the
default checkin cadence), the judge.  The sound program agrees with the
reference to float32 rounding; a step that keeps its state, a tower that
sees half its cutouts, the program's own int8 rungs (the control, with
bf16 towers), and in ``tiny.run`` a latent taken from random codes in
place of the encoded init each come out not correct.  The reference's
vector-prompt rows are the program's prompt table's."""

from __future__ import annotations

import time

import pytest
import torch
from conftest_tiny import tiny_checkout, tiny_vectors
from readings import CONTROL_RUNGS, environment, half_batch, init_unencoded, unchanged_steps

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


def run(checkout, name, traffic=None, **program):
    cell = C.load(name, *checkout)
    cell.config["program"].update(program)
    cell.traffic["program"].update(traffic or {})
    with environment(tiny_vectors(checkout[1])):
        return measure(cell, SEED, 0.5, False, "cpu", time.perf_counter())


CELLS = ["tiny.pixel", "tiny.vqgan", "tiny.run"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_plain_path(checkout, name):
    result, lines = run(checkout, name)
    assert result["correct"], lines
    for check in result["checks"].values():
        assert check["value"] < 1e-4  # float32 rounding
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"steps_per_s", "setup_s"}
    assert result["device"]["platform"] == "cpu"
    if name == "tiny.run":  # the init checked by itself, the codes of both encoders the same
        assert {"init_gap", "init_quant_gap"} <= set(result["checks"])
        assert "init_code_share 0.0 not compared" in lines


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [unchanged_steps, half_batch])
def test_a_broken_step_is_not_correct(checkout, name, fault):
    with fault():
        result, lines = run(checkout, name)
    assert not result["correct"], lines


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(checkout, name):
    with environment(CONTROL_RUNGS):
        result, lines = run(checkout, name, precision="bf16")
    assert not result["correct"], lines


def test_an_unencoded_init_is_not_correct(checkout):
    """The latent taken from random codes: the steps from it agree, the encoding agrees, the init does not."""
    with init_unencoded():
        result, lines = run(checkout, "tiny.run")
    assert not result["correct"], lines
    checks = result["checks"]
    assert checks["init_gap"]["value"] < checks["init_gap"]["limit"]
    assert checks["loss_gap"]["value"] < checks["loss_gap"]["limit"]
    assert checks["init_quant_gap"]["value"] > 0.5  # about sqrt(2): other codes of unit-normal rows


def test_a_run_without_an_init_encoding_is_not_correct(checkout):
    """A cell that starts from the program's latent, on a program that encoded no init image."""
    result, lines = run(checkout, "tiny.run", traffic={"init_noise": None})
    assert not result["correct"], lines
    assert any(line.startswith("init_gap nan") for line in lines)


@pytest.mark.parametrize("weight", ["", ":2.5"])
def test_vector_rows_are_the_programs_prompt_table(weight):
    """``textoff`` in the reference is the program's prompt table row for each tower (``engine/prompts.py``)."""
    from types import SimpleNamespace

    from pixray_tpu_torch.engine.prompts import build_prompt_tables

    from portbench.reference.step import vector_rows

    names = ["ViT-B/32", "ViT-B/16"]
    args = SimpleNamespace(prompts=[], vector_prompts=[f"textoff{weight}"], spot_prompts=None, spot_prompts_off=None,
                           labels=None, noise_prompt_seeds=None, animation_dir=None)
    perceptors = [SimpleNamespace(name=n, output_dim=512) for n in names]
    tables = build_prompt_tables(args, perceptors)[0]
    settings = {"vector_prompts": [f"textoff{weight}"], "root": C.ROOT}
    for name in names:
        rows = vector_rows(settings, name, "cpu")
        assert len(rows) == tables[name].size == 1
        assert torch.equal(rows[0][0], tables[name].embeds[0])
        assert rows[0][1] == pytest.approx(float(tables[name].weights[0]))
