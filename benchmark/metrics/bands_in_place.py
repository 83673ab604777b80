"""`bands_in_place`: the program's `fetch/bands_in_place` counter, the
panorama bands of the FINAL pass that the copy engine landed straight in
one pinned host panorama (`compose._HostFetch` on the card), with no
host-side assembly after the last feed.

Read from the counters the program keeps in the fenced part of a traced
run (`profiling.get_counters()`, kept by `program_record`): bands per
stitch. A program that assembles its bands on the host counts none and
gives nothing to read."""

from benchmark import program_record

program_record.arm()


def read(ctx):
    n = program_record.counters().get("fetch/bands_in_place")
    if not ctx.fenced or n is None:
        return None
    return n / ctx.fenced
