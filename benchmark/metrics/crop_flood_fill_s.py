"""`crop_flood_fill_s`: the program's own `low/crop/flood_fill` span (the
LOW panorama mask's copy to the host and `cropper.single_region`'s flood
fill), a part of `crop_s`.

Read from the spans the program records in the fenced part of a traced
run (`profiling.get_spans()`, kept by `program_record`): seconds per
stitch."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    s = program_record.span_seconds("low/crop/flood_fill")
    if not ctx.fenced or s is None:
        return None
    return s / ctx.fenced
