"""Graph cache: replays over packed dispatches in the window (eager,
captured and replayed), from the deltas of graphs.graph_stats()."""


def read(r):
    g = r.window.graphs
    total = g.get("eager", 0) + g.get("captures", 0) + g.get("replays", 0)
    return 100.0 * g["replays"] / total if total else None
