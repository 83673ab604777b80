"""Cells, configurations, traffic, limits and metrics found by name; a
cell and a metric added by adding files and entries only."""

import json
import os
import shutil
import types

from benchmark.manifest import HERE, ROOT, Manifest


def test_every_cell_finds_its_files():
    man = Manifest()
    names = [w["name"] for w in man.data["workloads"]]
    assert names and len(set(names)) == len(names)
    # a metric that lists its cells names cells of the manifest
    for m in man.data["end_to_end"] + man.data["per_layer"]:
        assert set(m.get("workloads", names)) <= set(names), m["name"]
    for name in names:
        cell = man.workload(name)
        cfg = man.config(cell["config"])
        assert cfg["stitcher"] in ("Stitcher", "AffineStitcher")
        assert man.traffic(cell["traffic"])["pool"] >= 3
        assert set(man.limits(name)) == {
            "reg_err_px", "pano_gap_mean", "pano_gap_p999",
            "uncovered_share", "crop_outside_share", "crop_area_short"}
        e2e = {m["name"] for m in man.end_to_end(name)}
        assert {"panorama_mp_per_s", "setup_s"} <= e2e
        for m in man.per_layer(name):
            assert hasattr(man.metric_reader(m["name"]), "read")


def test_manifest_keeps_the_contract_shape():
    data = Manifest().data
    assert data["command"] == ["python3", "benchmark/run.py"]
    assert data["paths"] == ["benchmark"]
    assert 1 <= data["run_seconds"] <= 51
    for c in data["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in data["per_layer"]:
        assert m["moves"] == "panorama_mp_per_s"
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))


def test_a_cell_and_a_metric_added_by_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    bdir = root / "benchmark"
    (bdir / "traffic" / "rot4-2mp.json").write_text(json.dumps(
        {**json.loads((bdir / "traffic" / "rot8-2mp.json").read_text()),
         "views": 4}))
    (bdir / "limits" / "pano-default.rot4-2mp.json").write_text(
        (bdir / "limits" / "pano-default.rot8-2mp.json").read_text())
    (bdir / "metrics" / "stitches_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.traced) or None\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["workloads"].append(
        {"name": "pano-default.rot4-2mp", "config": "pano-default",
         "traffic": "rot4-2mp", "chips": 1, "why": "four views"})
    data["per_layer"].append(
        {"name": "stitches_traced", "unit": "stitches", "better": "higher",
         "source": "program_counter", "layer": "entry, engine",
         "moves": "panorama_mp_per_s",
         "workloads": ["pano-default.rot4-2mp"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(root=str(root), bench_dir=str(bdir))
    cell = man.workload("pano-default.rot4-2mp")
    assert man.traffic(cell["traffic"])["views"] == 4
    assert man.limits(cell["name"])["pano_gap_p999"] > 0
    names = [m["name"] for m in man.per_layer(cell["name"])]
    assert "stitches_traced" in names
    assert "stitches_traced" not in [
        m["name"] for m in man.per_layer("scan-sift.row8-2mp")]
    reader = man.metric_reader("stitches_traced")
    assert reader.read(types.SimpleNamespace(traced=3)) == 3.0
    # no file that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())
