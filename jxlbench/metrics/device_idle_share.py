"""Device: 1 - busy / window, busy being the union of the device
operations' intervals in the torch.profiler trace of the window."""


def read(r):
    t = r.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
