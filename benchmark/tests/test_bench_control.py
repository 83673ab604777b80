"""The control, the reference in the program's place computed in
bfloat16, comes out not correct: put in the place of `run.Bench`, a run
of the harness reports `correct` false. Here at a shrunken size on the
CPU; on the card at the cells' own sizes in this file's `cuda` test.
`control.py`'s readings (program, control and the crop's fault) are
checked against the limits too."""

import json

import pytest

from benchmark import control, run
from benchmark.manifest import Manifest

CELLS = ("scan-sift.row8-2mp", "pano-default.rot6-12mp")
# (shrink, seed): sizes at which the port registers every view on the CPU
TINY = {"scan-sift.row8-2mp": (0.5, 1),
        "pano-default.rot6-12mp": (0.2, 7)}


def control_run(monkeypatch, capsys, cell, seed, seconds, **kw):
    monkeypatch.setattr(run, "Bench", control.ControlBench)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", "0"], **kw)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_control_run_is_not_correct(cell, monkeypatch, capsys):
    shrink, seed = TINY[cell]
    line = control_run(monkeypatch, capsys, cell, seed, 0.1, device="cpu",
                       shrink=shrink, pool=1)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def failed_limits(numbers, limits):
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_readings_control_and_fault_fail_program_passes(cell, capsys):
    shrink, seed = TINY[cell]
    limits = Manifest().limits(cell)
    assert control.main(["--workload", cell, "--seeds", str(seed)],
                        device="cpu", shrink=shrink) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert not failed_limits(row["program"], limits), row
    assert failed_limits(row["control"], limits), row
    assert failed_limits(row["crop_to_bbox"], limits), row


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_run_is_not_correct_at_cell_size(cell, card, monkeypatch,
                                                 capsys):
    line = control_run(monkeypatch, capsys, cell, 11, 3)
    assert line["correct"] is False
