"""`device_ops_per_stitch`: device operations (kernels, copies, sets) in
the profiled part of a traced run, per stitch. Each is dispatched by the
host, so the count bounds a stitch's host time from below."""


def read(ctx):
    if not ctx.device or not ctx.traced:
        return None
    return len(ctx.device) / ctx.traced
