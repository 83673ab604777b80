"""`cuda_mallocs_per_stitch`: the caching allocator's `cudaMalloc` calls
(`torch.cuda.memory_stats()["num_device_alloc"]`) over the profiled part
of a traced run, per stitch. A warm allocator makes none; each one is a
host stall that shows as an idle gap. Absent off the card."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.device_allocs()
    if not ctx.traced or n is None:
        return None
    return n / ctx.traced
