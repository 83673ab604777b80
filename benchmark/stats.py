"""Statistics the benchmark reports, and the spread its bounds come from.

    python benchmark/stats.py <file> [<file> ...]

reads result lines (the last JSON line of each file, one run each) and
prints, per metric, the runs' median and spread: the distance between the
first and third quartile (Python's `statistics.quantiles`, n=4) as a
share of the median, the measure that `BENCHMARK.json`'s bounds are set
from, and the spread once the run farthest from the median is left out.
"""

import json
import math
import statistics
import sys


def nearest_rank(values, q):
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a share q of all values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def spread(values):
    """Distance between the first and third quartile as a share of the
    median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values):
    """The spread without the value farthest from the median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread(values[:far] + values[far + 1:])


def main(paths):
    runs = []
    for p in paths:
        with open(p) as fh:
            lines = [x for x in fh.read().splitlines() if x.startswith("{")]
        if lines:
            runs.append(json.loads(lines[-1]))
    names = sorted({k for r in runs for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in runs
                if name in r["metrics"]]
        sp = spread(vals) if len(vals) > 1 else float("nan")
        tr = trimmed_spread(vals) if len(vals) > 2 else float("nan")
        print(f"{name}: n={len(vals)} median={statistics.median(vals):.6g} "
              f"spread={sp:.4%} trimmed={tr:.4%} "
              f"values={[round(v, 6) for v in vals]}")
    print(f"correct: {[r['correct'] for r in runs]}")


if __name__ == "__main__":
    main(sys.argv[1:])
