"""Dispatch window: stage `codec_tables` (TokenCodec.tables() at each
dispatch, built or reused) over the window's images, in ms per dispatch
(the counter `dispatches`, bootstrap and wide re-dispatches included)."""


def read(r):
    imgs = r.window.images
    n = sum(i.counters.get("dispatches", 0) for i in imgs)
    if not n or not any("codec_tables" in i.stages for i in imgs):
        return None
    return sum(i.stages.get("codec_tables", 0.0) for i in imgs) / n * 1e3
