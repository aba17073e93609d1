"""``host_reads_per_call`` (reads): the device-to-host reads a call of the
window made (its flag reads, the copies of its result and of its start),
the mean of ``host_reads`` over the program's call records of the window.
Nothing to read from a program without call records.
"""

from portbench import program


def read(ctx):
    records = program.window_records(ctx)
    if records is None:
        return None
    return sum(r["host_reads"] for r in records) / len(records)
