"""`flood_fill_rounds`: the program's `crop/flood_rounds` counter, the
dilation rounds of the crop planner's flood fill (`cropper.single_region`;
about the LOW panorama's width plus height).

Read from the counters the program keeps in the fenced part of a traced
run (`profiling.get_counters()`, kept by `program_record`): rounds per
stitch."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.counters().get("crop/flood_rounds")
    if not ctx.fenced or n is None:
        return None
    return n / ctx.fenced
