"""Dispatch window: the share of dispatches whose TokenCodec.tables()
built the code tables rather than reusing them, 100 *
codec_table_builds / dispatches over the window's images."""


def read(r):
    imgs = r.window.images
    n = sum(i.counters.get("dispatches", 0) for i in imgs)
    if not n:
        return None
    return 100.0 * sum(i.counters.get("codec_table_builds", 0)
                       for i in imgs) / n
