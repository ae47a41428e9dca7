"""Graph cache: the MiB the live graphs' pools hold reserved at the
window's end (graph_stats() reserved_mib, summed over devices)."""


def read(r):
    g = r.window.graphs
    if not (g.get("eager", 0) + g.get("captures", 0) + g.get("replays", 0)):
        return None
    return float(g["reserved_mib"])
