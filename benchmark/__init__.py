"""The benchmark of the PyTorch and CUDA port (`stitching_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json`; everything that belongs to
one configuration, traffic mix, per-layer metric or cell's limits is a
file of its own under `configs/`, `traffic/`, `metrics/` and `limits/`,
found by its name.
"""
