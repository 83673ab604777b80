"""`match_pairs`: the program's `match/pairs` counter, the candidate pairs
of views that the 2-NN and RANSAC take (`pipeline.match_stack_dispatch`):
n (n - 1) / 2 of n views, 153 on a 3 x 6 grid.

Read from the counters the program keeps in the fenced part of a traced
run (`profiling.get_counters()`, kept by `program_record`): pairs per
stitch."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.counters().get("match/pairs")
    if not ctx.fenced or n is None:
        return None
    return n / ctx.fenced
