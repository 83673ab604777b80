"""`crop_s`: the `low/crop` stage (the LOW paste mask, the crop planner and
slicing the LOW tiles).

Read from the fenced part of a traced run (the program's stage timers,
`profiling.enable_fence()`): seconds per stitch."""


def read(ctx):
    if not ctx.fenced or not ctx.spans.seen(name="low/crop"):
        return None
    return ctx.spans.total(name="low/crop") / ctx.fenced
