"""`crop_label_launches`: the program's `crop/label_launches` counter, the
kernel launches of the crop planner's region count on the card
(`cropper.single_region` on a mask there; three a call).

Read from the counters the program keeps in the fenced part of a traced
run (`profiling.get_counters()`, kept by `program_record`): launches per
stitch. A program that counts no such launches (a mask flood filled on
the host) gives nothing to read."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.counters().get("crop/label_launches")
    if not ctx.fenced or n is None:
        return None
    return n / ctx.fenced
