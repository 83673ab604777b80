"""`BENCHMARK.json` and the files it names, found by name.

A configuration is `configs/<name>.json` (its `file` in the manifest), a
traffic mix `traffic/<name>.json`, a per-layer metric the reader
`metrics/<name>.py` and a cell's limits `limits/<cell>.json`. Adding a
cell or a metric adds files and entries; no file here changes.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


class Manifest:
    def __init__(self, root=ROOT, bench_dir=HERE):
        self.root = root
        self.dir = bench_dir
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return _json(os.path.join(self.dir, "traffic", name + ".json"))

    def limits(self, cell):
        return _json(os.path.join(self.dir, "limits", cell + ".json"))

    def end_to_end(self, cell):
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]

    def metric_reader(self, name):
        """The reader module of per-layer metric `name`."""
        path = os.path.join(self.dir, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark.metrics." + name.replace("-", "_").replace(".", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
