"""`seam_find_s`: the `low/seam_find` stage.

Read from the fenced part of a traced run (the program's stage timers,
`profiling.enable_fence()`): seconds per stitch."""


def read(ctx):
    if not ctx.fenced or not ctx.spans.seen(name="low/seam_find"):
        return None
    return ctx.spans.total(name="low/seam_find") / ctx.fenced
