"""The cell `pano-default.grid18-12mp`, added by files and entries alone:
its configuration `pano-grid` is `Stitcher()` on a multi-row capture, its
traffic is the grid that `test_bench_grid.py` draws, the manifest
finds its files, and the readers of the registration's two counters
read them per fenced stitch from the program's record, and nothing from
a program that keeps no such counter."""

import json
import os
import types

import pytest

from benchmark import program_record
from benchmark.manifest import HERE, Manifest
from benchmark.tests.test_bench_grid import GRID, GRID_CELL

COUNTERS = {"match_pairs": "match/pairs", "bundle_edges": "bundle/edges"}


def test_committed_traffic_is_the_grid():
    with open(os.path.join(HERE, "traffic", "grid18-12mp.json")) as fh:
        traffic = json.load(fh)
    assert traffic.pop("about")
    assert traffic == GRID


def test_the_cell_and_its_metrics_are_in_the_manifest():
    man = Manifest()
    cell = man.workload(GRID_CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pano-grid", "grid18-12mp", 1)
    assert len(cell["why"]) <= 200
    e2e = {m["name"] for m in man.end_to_end(GRID_CELL)}
    assert e2e == {"panorama_mp_per_s", "setup_s"}
    cells = [w["name"] for w in man.data["workloads"]]
    for name in COUNTERS:
        (m,) = [m for m in man.data["per_layer"] if m["name"] == name]
        assert m["layer"] == "registration" and m["workloads"] == cells
        assert m["source"] == "program_counter"
    limits = man.limits(GRID_CELL)
    assert 0 < limits["reg_err_px"] < 51.5   # the least bent set reads 51.50


def test_the_grid_config_runs_the_stitcher_defaults():
    """`pano-grid` is `Stitcher()` as `pano-default` runs it, on a
    multi-row capture, with a source of its own and nothing reduced."""
    man = Manifest()
    grid, default = man.config("pano-grid"), man.config("pano-default")
    for key in ("stitcher", "kwargs", "reference"):
        assert grid[key] == default[key]
    (entry,) = [c for c in man.data["configs"] if c["name"] == "pano-grid"]
    sources = [c["source"] for c in man.data["configs"] if c is not entry]
    assert entry["source"] not in sources and entry["reduced"] == []
    assert entry["source"].startswith(grid["source"])
    shape = grid["capture"]
    traffic = man.traffic(man.workload(GRID_CELL)["traffic"])
    assert shape["rows"] * shape["columns"] == shape["views"] == (
        traffic["views"])
    assert shape["rows"] == traffic["rows"]
    n = shape["views"]
    assert shape["candidate_pairs"] == n * (n - 1) // 2


@pytest.fixture
def readers(monkeypatch):
    got = {name: Manifest().metric_reader(name) for name in COUNTERS}
    kept = {"spans": [], "counters": {}, "allocs": []}
    monkeypatch.setattr(program_record, "_KEPT", kept)
    return got, kept


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_reader_counts_per_fenced_stitch(readers, name):
    got, kept = readers
    ctx = types.SimpleNamespace(fenced=3, traced=3)
    kept["counters"] = {"match/pairs": 459, "bundle/edges": 105,
                        "bundle/iterations": 60}
    want = {"match_pairs": 153, "bundle_edges": 35}[name]
    assert got[name].read(ctx) == want
    # a program that keeps no such counter (the port before them)
    kept["counters"] = {"bundle/iterations": 60}
    assert got[name].read(ctx) is None
    kept["counters"] = {COUNTERS[name]: 9}
    ctx.fenced = 0
    assert got[name].read(ctx) is None
