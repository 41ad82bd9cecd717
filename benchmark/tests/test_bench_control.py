"""The output check fails what it must: the lower-precision control at a
size a test run holds, and each fault a cell can have, planted in the
port underneath a whole run (the look for a card skipped, the CPU at tiny
widths). ``--control 1`` puts the control in the program's place, and the
harness's own comparison judges it; the real runs prove it at the cells'
own sizes on the card."""

import pytest
import torch

from benchmark.harness import core, faults
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 77
GUIDED = dict(size=64, steps=4, check={"requests": 1, "guided_steps": 2, "plain_steps": 1})
INJECT = dict(size=64, steps=3, batch=4, check={"requests": 1, "steps": 2, "chunk": 2})
TRAIN = dict(size=64, images=300, batch=2, sketch_fixed_size=64, profiled_steps=2,
             check={"start_within": 3})
CELLS = {"sd15-lgp.guided-b1-512-50": GUIDED, "sd15-inject.clip-b8-512-25": INJECT,
         "sd15-lgp.train-b4-512": TRAIN}


def run(name, control=False, bf16=False, seconds=1.0):
    cell = tiny_cell(name, **CELLS[name])
    if bf16:
        cell.config["dtypes"] = dict(core.find_cell(name).config["dtypes"])
    return core.run_cell(cell, SEED, seconds, False, torch.device("cpu"), control=control,
                         log=lambda m: None)


@pytest.mark.parametrize("name", list(CELLS))
def test_control_fails_a_limit(name):
    res = run(name, control=True, bf16=True)
    assert not res["correct"], res["compared"]
    limits = core.find_cell(name).limits["limits"]
    assert set(res["compared"]) == set(limits)
    assert any(v > lim for v, lim in res["compared"].values()), res["compared"]


FAULTS = [(cell, f) for cell in CELLS for f in
          faults.FAULTS[core.find_cell(cell).traffic["entry"]]]


@pytest.mark.parametrize("name", list(CELLS))
def test_sound_run_is_correct(name):
    assert run(name)["correct"]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_comes_out_not_correct(name, fault):
    with faults.planted(core.find_cell(name).traffic["entry"], fault):
        assert not run(name)["correct"]
