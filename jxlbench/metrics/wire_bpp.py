"""Link: bits per pixel that crossed it, 8 * (h2d_raw_bytes + 4 *
fetched_words) over the window's pixels (the Encoder's counters)."""


def read(r):
    imgs = r.window.images
    moved = sum(i.counters.get("h2d_raw_bytes", 0)
                + 4 * i.counters.get("fetched_words", 0) for i in imgs)
    return 8.0 * moved / r.window.pixels if moved else None
