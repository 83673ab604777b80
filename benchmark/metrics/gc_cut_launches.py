"""`gc_cut_launches`: the program's `gc/cut_launches` counter, the kernel
launches of the graph cut's min cut (`ops/graphcut.grid_min_cut` on the
card: one a level, the whole push-relabel loop of every pair in it).

Read from the counters the program keeps in the fenced part of a traced
run (`profiling.get_counters()`, kept by `program_record`): launches per
stitch. A program that counts no such launches (the cut as PyTorch ops)
gives nothing to read."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.counters().get("gc/cut_launches")
    if not ctx.fenced or n is None:
        return None
    return n / ctx.fenced
