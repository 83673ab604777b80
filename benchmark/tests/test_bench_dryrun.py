"""Every cell end to end at a shrunken size on the CPU: a well-formed
last line, both with `--trace 0` and `--trace 1`."""

import json

import pytest

from benchmark import run
from benchmark.manifest import Manifest

# (cell, shrink, seed): sizes at which the port registers every view on
# the CPU
TINY = {"scan-sift.row8-2mp": (0.5, 1),
        "pano-default.rot6-12mp": (0.2, 7)}


def last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_prints_a_well_formed_line(cell, trace, capsys):
    shrink, seed = TINY[cell]
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.1", "--trace", str(trace)], device="cpu",
                  shrink=shrink, pool=1)
    assert rc == 0
    line = last_line(capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    dev = line["device"]
    assert dev["count"] == 1 and dev["platform"] == "cpu"
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace == 0:
        assert set(line["metrics"]) == {
            m["name"] for m in Manifest().end_to_end(cell)}
    else:
        # the stage seconds; the device metrics need a card
        assert {"registration_s", "crop_s", "final_s"} <= set(
            line["metrics"])
        assert "sampler_roofline" not in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "scan-sift.row8-2mp", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
