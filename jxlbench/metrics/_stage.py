"""Shared by the stage readers: the mean per image, in ms, of the sum
of some EncodeStats stages (seconds summed over the threads that ran
them)."""


def mean_ms(r, *names):
    imgs = r.window.images
    if not imgs or not any(n in i.stages for i in imgs for n in names):
        return None
    return sum(sum(i.stages.get(n, 0.0) for n in names)
               for i in imgs) / len(imgs) * 1e3
