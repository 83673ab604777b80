"""Nothing a run or the reference loads is JAX or the JAX package (top-
level names compared whole: `stitching_tpu_torch` begins with
`stitching_tpu`), and the reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from benchmark.manifest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "stitching_tpu"}

RUN = """
import json, sys
from benchmark import run
rc = run.main(['--workload', 'pano-default.rot6-12mp', '--seed', '7',
               '--seconds', '0.1', '--trace', '0'], device='cpu',
              shrink=0.2, pool=1)
assert rc == 0, rc
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
from benchmark import reference, generators
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    top = set(_modules(RUN))
    assert "stitching_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules(REFERENCE)
    assert not [m for m in mods if m.split(".")[0] in
                FORBIDDEN | {"stitching_tpu_torch"}]


def test_the_reference_sources_import_nothing_of_the_port():
    for name in ("reference.py", "generators.py", "stats.py"):
        tree = ast.parse(open(os.path.join(HERE, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {
                    "stitching_tpu_torch"}, (name, m)
