"""The reader of the program's `registration/device_downscales` counter:
views per fenced stitch, and nothing where the program counts none."""

import types

from benchmark import program_record
from benchmark.manifest import Manifest

COUNTER = "registration/device_downscales"


def test_reads_views_per_fenced_stitch(monkeypatch):
    reader = Manifest().metric_reader("device_downscales")
    kept = {"spans": [], "counters": {}, "allocs": []}
    monkeypatch.setattr(program_record, "_KEPT", kept)
    ctx = types.SimpleNamespace(fenced=3, traced=3)
    kept["counters"] = {COUNTER: 24, "bundle/iterations": 40}
    assert reader.read(ctx) == 8
    # a program that downscales on the host, or records nothing
    kept["counters"] = {"bundle/iterations": 40}
    assert reader.read(ctx) is None
    kept["counters"] = {}
    assert reader.read(ctx) is None
    ctx.fenced = 0
    kept["counters"] = {COUNTER: 24}
    assert reader.read(ctx) is None


def test_listed_in_the_cells_that_downscale():
    man = Manifest()
    [entry] = [m for m in man.data["per_layer"]
               if m["name"] == "device_downscales"]
    assert entry["workloads"] == [w["name"] for w in man.data["workloads"]]
    for cell in entry["workloads"]:
        assert "device_downscales" in [m["name"]
                                       for m in man.per_layer(cell)]
