"""Host plane: the HF ANS's time per symbol, in ns: 1e9 * stage
`ans_encode` / counter `ans_symbols` (the symbols the native ANS
encoded), summed over the window's images.  Silent where the program
does not count ans_symbols."""


def read(r):
    imgs = r.window.images
    n = sum(i.counters.get("ans_symbols", 0) for i in imgs)
    if not n:
        return None
    return 1e9 * sum(i.stages.get("ans_encode", 0.0) for i in imgs) / n
