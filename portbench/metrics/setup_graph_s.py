"""``setup_graph_s`` (s): the host time of the program's chunk-graph
captures, ``(graph.first_chunk_ns + graph.record_ns +
graph.instantiate_ns) / 1e9`` of its counters: the eager first chunk, the
recording and the instantiation, summed over the captures.  No capture
falls in a window, so it is all set-up.  Nothing to read from a program
without the timers.
"""

from portbench import program

PARTS = ("graph.first_chunk_ns", "graph.record_ns", "graph.instantiate_ns")


def read(ctx):
    counts = program.counters()
    if not all(k in counts for k in PARTS):
        return None
    return sum(counts[k] for k in PARTS) / 1e9
