"""`bundle_edges`: the program's `bundle/edges` counter, the pairs of views
whose confidence passes the adjuster's threshold and whose inliers the
bundle adjustment takes (`camera_adjuster._pack_problem`): a camera
graph with loops on a grid, a chain and its near neighbours on a row.

Read from the counters the program keeps in the fenced part of a traced
run (`profiling.get_counters()`, kept by `program_record`): edges per
stitch."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.counters().get("bundle/edges")
    if not ctx.fenced or n is None:
        return None
    return n / ctx.fenced
