"""`stream_warp_s`: the program's own `final/stream/warp` spans (each
image's FINAL warp, crop slice, gain and seam resize on the streamed
branch), a part of `final_s`.

Read from the spans the program records in the fenced part of a traced
run (`profiling.get_spans()`, kept by `program_record`): seconds per
stitch."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    s = program_record.span_seconds("final/stream/warp")
    if not ctx.fenced or s is None:
        return None
    return s / ctx.fenced
