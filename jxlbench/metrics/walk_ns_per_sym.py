"""Host plane: the packed walk's time per symbol, in ns: 1e9 * stage
`walk` / counter `walk_symbols` (the symbols the device counted for
the LF groups walked), summed over the window's images.  Silent where
the program does not count walk_symbols."""


def read(r):
    imgs = r.window.images
    n = sum(i.counters.get("walk_symbols", 0) for i in imgs)
    if not n:
        return None
    return 1e9 * sum(i.stages.get("walk", 0.0) for i in imgs) / n
