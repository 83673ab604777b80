"""`bundle_iterations`: the program's `bundle/iterations` counter, the LM
loop's trial steps (accepted and rejected; `ops/bundle._lm_engine`), each
one host read.

Read from the counters the program keeps in the fenced part of a traced
run (`profiling.get_counters()`, kept by `program_record`): steps per
stitch."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.counters().get("bundle/iterations")
    if not ctx.fenced or n is None:
        return None
    return n / ctx.fenced
