"""`device_downscales`: the program's `registration/device_downscales`
counter, the views whose MEDIUM and LOW registration inputs were made on
the card (`engine._downscale_landed`, one kernel launch a view) rather
than resized on the host.

Read from the counters the program keeps in the fenced part of a traced
run (`profiling.get_counters()`, kept by `program_record`): views per
stitch. A program that downscales on the host gives nothing to read."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.counters().get("registration/device_downscales")
    if not ctx.fenced or n is None:
        return None
    return n / ctx.fenced
