"""`registration_s`: the registration stages (`registration/*`: the host
downscales, the uploads, detection, matching, subsetting, the estimate,
bundle adjustment and wave correction), those not inside another stage.

Read from the fenced part of a traced run (the program's stage timers,
`profiling.enable_fence()`): seconds per stitch."""


def read(ctx):
    if not ctx.fenced or not ctx.spans.seen(prefix="registration/"):
        return None
    return ctx.spans.total(prefix="registration/", top=True) / ctx.fenced
