"""`device_peak_gb`: `torch.cuda.max_memory_allocated` over the profiled
part of a traced run (reset at its start), in GB (1e9 bytes)."""


def read(ctx):
    if not ctx.on_card:
        return None
    return ctx.peak_bytes / 1e9
