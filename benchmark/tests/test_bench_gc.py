"""The cell `pano-gc.rot6-12mp` (`Stitcher(finder="gc_color")`): its
files found by name, its dry runs on the CPU at a shrunken size, its
control, and the three metrics that read the graph cut's span and
counters (`gc_cut_s`, `gc_iterations`, `gc_host_reads`)."""

import json
import types

import pytest

from benchmark import control, program_record, run
from benchmark.manifest import Manifest

CELL = "pano-gc.rot6-12mp"
# (shrink, seed): as the 12 MP cell of the same traffic in
# test_bench_dryrun.py, a size at which the port registers every view on
# the CPU
SHRINK, SEED = 0.2, 7
GC = {"gc_cut_s": "low/seam_find/cut", "gc_iterations": "gc/iterations",
      "gc_host_reads": "gc/host_reads"}


def last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_cell_finds_its_files():
    man = Manifest()
    cell = man.workload(CELL)
    cfg = man.config(cell["config"])
    assert cfg["stitcher"] == "Stitcher"
    assert cfg["kwargs"] == {"finder": "gc_color"}
    assert cfg["reference"] == man.config("pano-default")["reference"]
    assert cell["traffic"] == man.workload(
        "pano-default.rot6-12mp")["traffic"]
    assert set(man.limits(CELL)) == set(man.limits("pano-default.rot6-12mp"))
    # the 12 MP p90 spreads too widely for a bound (PERF.md)
    assert {m["name"] for m in man.end_to_end(CELL)} == {
        "panorama_mp_per_s", "setup_s"}
    layer = {m["name"] for m in man.per_layer(CELL)}
    assert set(GC) <= layer
    # the same crop as pano-default's, on the card
    assert "crop_label_launches" in layer
    for other in ("scan-sift.row8-2mp", "pano-default.rot6-12mp"):
        assert not set(GC) & {m["name"] for m in man.per_layer(other)}
    for name in GC:
        assert hasattr(man.metric_reader(name), "read")


@pytest.fixture
def readers(monkeypatch):
    got = {name: Manifest().metric_reader(name) for name in GC}
    kept = {"spans": [], "counters": {}, "allocs": []}
    monkeypatch.setattr(program_record, "_KEPT", kept)
    return got, kept


def test_readers_per_fenced_stitch(readers):
    got, kept = readers
    ctx = types.SimpleNamespace(fenced=2, traced=3)
    kept["spans"] = [("low/seam_find/cut", "low/seam_find", 1,
                      int(10e9), int(10.25e9)),
                     ("low/seam_find/cut", "low/seam_find", 1,
                      int(11e9), int(11.5e9)),
                     ("low/seam_find", None, 1, int(9e9), int(12e9))]
    kept["counters"] = {"gc/iterations": 300, "gc/host_reads": 130,
                        "gc/levels": 4}
    assert got["gc_cut_s"].read(ctx) == pytest.approx(0.375)
    assert got["gc_iterations"].read(ctx) == 150
    assert got["gc_host_reads"].read(ctx) == 65


def test_a_program_without_the_cut_reads_nothing(readers):
    got, kept = readers
    ctx = types.SimpleNamespace(fenced=3, traced=3)
    kept["spans"] = [("low/seam_find", None, 1, 0, 10)]
    kept["counters"] = {"bundle/iterations": 40}
    assert all(r.read(ctx) is None for r in got.values())


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run(trace, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.1", "--trace", str(trace)], device="cpu",
                  shrink=SHRINK, pool=1)
    assert rc == 0
    line = last_line(capsys)
    assert line["correct"] is True and line["failed"] == 0
    metrics = line["metrics"]
    if trace == 0:
        assert set(metrics) == {"panorama_mp_per_s", "setup_s"}
        return
    for name in GC:
        assert metrics[name]["value"] > 0, name
    assert metrics["gc_cut_s"]["value"] < metrics["seam_find_s"]["value"]
    assert metrics["gc_iterations"]["value"] == int(
        metrics["gc_iterations"]["value"])
    # the CPU floods the crop's mask on the host: no launch to count
    assert "crop_label_launches" not in metrics


def test_control_is_not_correct(monkeypatch, capsys):
    monkeypatch.setattr(run, "Bench", control.ControlBench)
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.1", "--trace", "0"], device="cpu", shrink=SHRINK,
                  pool=1)
    assert rc == 0
    line = last_line(capsys)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_readings_control_and_fault_fail_program_passes(capsys):
    limits = Manifest().limits(CELL)
    assert control.main(["--workload", CELL, "--seeds", str(SEED)],
                        device="cpu", shrink=SHRINK) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[0])

    def failed(numbers):
        return [k for k, v in numbers.items() if not v <= limits[k]]

    assert not failed(row["program"]), row
    assert failed(row["control"]), row
    assert failed(row["crop_to_bbox"]), row


@pytest.mark.cuda
def test_control_run_is_not_correct_at_cell_size(card, monkeypatch, capsys):
    monkeypatch.setattr(run, "Bench", control.ControlBench)
    assert run.main(["--workload", CELL, "--seed", "11", "--seconds", "3",
                     "--trace", "0"]) == 0
    assert last_line(capsys)["correct"] is False
