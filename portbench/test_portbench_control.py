"""The correctness check must fail what it is there to catch.

On the CPU at toy widths (``tiny.py``): the control (the reference computed
in float8 in the program's place) fails at least one of a cell's limits
where the program passes them all; and a run with the timed path broken
underneath (the card's look skipped, the rest of the run as it is) comes
out ``correct`` false, once for each fault the cell can have.  On the card
(``gpu``): the control at the cell's own size on three seeds,
``bench/control.py``'s readings.

    python -m pytest portbench/test_portbench_control.py -q
    python -m pytest portbench/test_portbench_control.py -q -m gpu   # on the card
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from portbench.bench import control, manifest, session
from portbench.bench.faults import FAULTS
from portbench.tiny import tiny_cell

torch.set_num_threads(2)
CELLS = ("v3d512.generate", "sd21-v768.txt2img", "v3d512.finetune")
SEED = 2**31 + 21


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    cell = tiny_cell(name)
    (_, program), (_, ctl) = control.readings(cell, SEED, True, device="cpu")
    assert all(program[k] <= v for k, v in cell.limits.items()), (program, cell.limits)
    assert any(ctl[k] > v for k, v in cell.limits.items()), (ctl, cell.limits)


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    FAULTS[name][fault](monkeypatch)
    result = session.run(cell, SEED, 0.0, False, device="cpu")
    assert result["correct"] is False, result["checks"]


def test_the_sound_tiny_runs_are_correct():
    for name in CELLS:
        result = session.run(tiny_cell(name), SEED, 0.0, False, device="cpu")
        assert result["correct"], (name, result["checks"])


# -- on the card, at the cell's own size --------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_at_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    cell = manifest.load_cell(name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        (_, program), (_, ctl) = control.readings(cell, seed, True)
        assert all(program[k] <= v for k, v in cell.limits.items()), (seed, program)
        assert any(ctl[k] > v for k, v in cell.limits.items()), (seed, ctl)
        with contextlib.suppress(AttributeError):
            torch.cuda.empty_cache()
