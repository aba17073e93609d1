"""``entry_ms_per_call`` (ms): the host time a call of the window spent in
the facade outside its chunk loops, the mean of ``entry_self_ns`` (a
call's wall less its outermost ``zt.drive`` spans) over the program's call
records of the window.  Nothing to read from a program without call
records.
"""

from portbench import program


def read(ctx):
    records = program.window_records(ctx)
    if records is None:
        return None
    return sum(r["entry_self_ns"] for r in records) / len(records) / 1e6
