"""``graph_nodes_per_step`` (nodes): the nodes of the chunk graphs the
program captured over the steps they hold, ``graph.nodes / graph.steps``
of its counters (every capture falls in the set-up).  A node is one
launch a replay makes: a kernel, a copy or a set.  Nothing to read where
the program counted no nodes (no capture on a card, or no such counter).
"""

from portbench import program


def read(ctx):
    counts = program.counters()
    nodes, steps = counts.get("graph.nodes"), counts.get("graph.steps")
    return nodes / steps if nodes is not None and steps else None
