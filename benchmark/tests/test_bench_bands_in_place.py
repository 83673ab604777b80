"""`bands_in_place` reads the program's `fetch/bands_in_place` counter
(`program_record`): the count per fenced stitch, and nothing where the
program does not count it (a program that assembles its bands on the
host) or no stitch was fenced."""

import sys
import types

import pytest

from benchmark import program_record
from benchmark.manifest import Manifest


@pytest.fixture
def reader(monkeypatch):
    """The reader, loaded as a run loads it, over a record the test fills
    in."""
    got = Manifest().metric_reader("bands_in_place")
    kept = {"spans": [], "counters": {}, "allocs": []}
    monkeypatch.setattr(program_record, "_KEPT", kept)
    return got, kept


def test_bands_per_fenced_stitch(reader):
    got, kept = reader
    kept["counters"] = {"fetch/bands_in_place": 21, "bundle/iterations": 40}
    assert got.read(types.SimpleNamespace(fenced=3, traced=3)) == 7
    assert got.read(types.SimpleNamespace(fenced=2, traced=3)) == 10.5
    assert got.read(types.SimpleNamespace(fenced=0, traced=3)) is None


def test_absent_counter_reads_nothing(reader):
    """The parent program, and the CPU, count no band landed in place."""
    got, kept = reader
    kept["counters"] = {"bundle/iterations": 40, "match/pairs": 45}
    assert got.read(types.SimpleNamespace(fenced=3, traced=3)) is None
    kept["counters"] = {}
    assert got.read(types.SimpleNamespace(fenced=3, traced=3)) is None


def test_a_program_without_a_record_reads_nothing(monkeypatch):
    """A program with no counters at all gives nothing, and nothing
    raises."""
    prog = types.SimpleNamespace(reset=lambda: None)
    monkeypatch.setitem(sys.modules, program_record.PROFILING, prog)
    monkeypatch.setattr(program_record, "_KEPT", dict(program_record._KEPT))
    got = Manifest().metric_reader("bands_in_place")
    prog.reset()
    assert got.read(types.SimpleNamespace(fenced=3, traced=3)) is None


def test_listed_for_every_cell():
    man = Manifest()
    cells = [w["name"] for w in man.data["workloads"]]
    for cell in cells:
        assert "bands_in_place" in [m["name"] for m in man.per_layer(cell)]
