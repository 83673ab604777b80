"""`upload_wait_s`: the `final/upload_wait` stage (the FINAL pass waiting on
the originals' upload), a part of `final_s`.

Read from the fenced part of a traced run (the program's stage timers,
`profiling.enable_fence()`): seconds per stitch."""


def read(ctx):
    if not ctx.fenced or not ctx.spans.seen(name="final/upload_wait"):
        return None
    return ctx.spans.total(name="final/upload_wait") / ctx.fenced
