"""`final_s`: the FINAL composite (`final/*` stages not inside another:
`final/plan`, `final/stream` and `final/blend` on the streamed branch,
the batched branch's warp, crop, gains, seam resize, blend and
download).

Read from the fenced part of a traced run (the program's stage timers,
`profiling.enable_fence()`): seconds per stitch."""


def read(ctx):
    if not ctx.fenced or not ctx.spans.seen(prefix="final/"):
        return None
    return ctx.spans.total(prefix="final/", top=True) / ctx.fenced
