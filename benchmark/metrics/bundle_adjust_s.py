"""`bundle_adjust_s`: the `registration/bundle_adjust` stage, a part of
`registration_s`.

Read from the fenced part of a traced run (the program's stage timers,
`profiling.enable_fence()`): seconds per stitch."""


def read(ctx):
    if not ctx.fenced or not ctx.spans.seen(name="registration/bundle_adjust"):
        return None
    return ctx.spans.total(name="registration/bundle_adjust") / ctx.fenced
