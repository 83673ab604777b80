"""The metrics that read the program's own record (`program_record`):
each reader's arithmetic on a hand-built record, nothing read from a
program that records nothing, and a traced dry run on the CPU."""

import json
import sys
import types

import pytest

from benchmark import program_record, run
from benchmark.manifest import Manifest

SPANS = ("crop_flood_fill_s", "stream_warp_s")
COUNTERS = {"crop_label_launches": "crop/label_launches",
            "bundle_iterations": "bundle/iterations"}
NEW = (*SPANS, *COUNTERS, "cuda_mallocs_per_stitch")


@pytest.fixture
def readers(monkeypatch):
    """The new readers, loaded as a run loads them, over a record the
    test fills in."""
    got = {name: Manifest().metric_reader(name) for name in NEW}
    kept = {"spans": [], "counters": {}, "allocs": []}
    monkeypatch.setattr(program_record, "_KEPT", kept)
    return got, kept


def span(name, start_s, end_s):
    return (name, None, 1, int(start_s * 1e9), int(end_s * 1e9))


def test_span_readers_per_fenced_stitch(readers):
    got, kept = readers
    ctx = types.SimpleNamespace(fenced=2, traced=3)
    kept["spans"] = [span("low/crop/flood_fill", 10.0, 10.5),
                     span("low/crop/flood_fill", 20.0, 20.25),
                     span("low/crop", 9.0, 21.0),
                     span("final/stream/warp", 30.0, 30.1),
                     span("final/stream/warp", 31.0, 31.3)]
    assert got["crop_flood_fill_s"].read(ctx) == pytest.approx(0.375)
    assert got["stream_warp_s"].read(ctx) == pytest.approx(0.2)
    kept["spans"] = [span("low/crop", 9.0, 21.0)]
    for name in SPANS:
        assert got[name].read(ctx) is None
    ctx.fenced = 0
    kept["spans"] = [span("final/stream/warp", 30.0, 30.1)]
    assert got["stream_warp_s"].read(ctx) is None


def test_counter_readers_per_fenced_stitch(readers):
    got, kept = readers
    ctx = types.SimpleNamespace(fenced=4, traced=3)
    kept["counters"] = {"crop/label_launches": 12, "bundle/iterations": 60}
    assert got["crop_label_launches"].read(ctx) == 3
    assert got["bundle_iterations"].read(ctx) == 15
    # a mask flood filled on the host counts rounds, not launches
    kept["counters"] = {"crop/flood_rounds": 8000, "bundle/iterations": 60}
    assert got["crop_label_launches"].read(ctx) is None
    kept["counters"] = {}
    assert got["bundle_iterations"].read(ctx) is None


def test_mallocs_per_traced_stitch(readers):
    got, kept = readers
    ctx = types.SimpleNamespace(fenced=3, traced=3)
    kept["allocs"] = [40, 46]
    assert got["cuda_mallocs_per_stitch"].read(ctx) == 2
    kept["allocs"] = [40, 40]
    assert got["cuda_mallocs_per_stitch"].read(ctx) == 0
    for allocs in ([], [40], [None, None], [40, None]):
        kept["allocs"] = allocs         # off the card, or never read
        assert got["cuda_mallocs_per_stitch"].read(ctx) is None


def test_reset_keeps_what_it_clears(monkeypatch):
    """The first reset after `arm()` reads the allocator again; each
    reset keeps the program's spans and counters before clearing them."""
    record = {"spans": [span("low/crop/flood_fill", 1.0, 2.0)],
              "counters": {"crop/flood_rounds": 7}}
    cleared = []
    prog = types.SimpleNamespace(
        get_spans=lambda: list(record["spans"]),
        get_counters=lambda: dict(record["counters"]),
        reset=lambda: cleared.append(True))
    monkeypatch.setitem(sys.modules, program_record.PROFILING, prog)
    monkeypatch.setattr(program_record, "_KEPT", dict(program_record._KEPT))
    reads = iter([100, 103, 999])
    monkeypatch.setattr(program_record, "_device_allocs",
                        lambda: next(reads))
    program_record.arm()
    program_record.arm()                # a second reader: wrapped once
    prog.reset()
    record["counters"] = {"crop/flood_rounds": 9}
    prog.reset()
    assert cleared == [True, True]
    assert program_record.counters() == {"crop/flood_rounds": 9}
    assert program_record.span_seconds("low/crop/flood_fill") == 1.0
    assert program_record.device_allocs() == 999 - 103


def test_a_program_without_a_record_reads_nothing(monkeypatch):
    """A program with no spans or counters (the port before them) gives
    the readers nothing to read, and nothing raises."""
    prog = types.SimpleNamespace(reset=lambda: None)
    monkeypatch.setitem(sys.modules, program_record.PROFILING, prog)
    monkeypatch.setattr(program_record, "_KEPT", dict(program_record._KEPT))
    got = {name: Manifest().metric_reader(name) for name in NEW}
    prog.reset()
    ctx = types.SimpleNamespace(fenced=3, traced=3)
    assert all(r.read(ctx) is None for r in got.values())


# (shrink, seed) as in test_bench_dryrun.py
TINY = {"scan-sift.row8-2mp": (0.5, 1),
        "pano-default.rot6-12mp": (0.2, 7)}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_dry_run_reads_the_program_record(cell, capsys):
    shrink, seed = TINY[cell]
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.1", "--trace", "1"], device="cpu", shrink=shrink,
                  pool=1)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metrics = line["metrics"]
    for name in (*SPANS, "bundle_iterations"):
        assert metrics[name]["value"] > 0, name
    assert metrics["bundle_iterations"]["value"] == int(
        metrics["bundle_iterations"]["value"])
    # the CPU floods the crop's mask on the host: no launch to count
    assert "crop_label_launches" not in metrics
    # the flood fill is a part of the crop stage, the warps of FINAL
    assert metrics["crop_flood_fill_s"]["value"] < metrics["crop_s"]["value"]
    assert metrics["stream_warp_s"]["value"] < metrics["final_s"]["value"]
    assert "cuda_mallocs_per_stitch" not in metrics    # no card
