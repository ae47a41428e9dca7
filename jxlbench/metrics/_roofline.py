"""Shared by the kernel rows: a kernel's share of its roofline, the
least time (jxlbench/kernels.py's bytes for the window's images over
the device's memory rate, jxlbench/peaks.json) over its device time in
the trace, matched by the kernel's name.  Only a trace that holds every
launch the program's launch counter counted in the window is read: one
that lost or gained launches gives no share, and says so on stderr."""

import sys


def share(r, kernel, trace_name):
    t = r.trace
    if t is None or r.peaks is None:
        return None
    sec, seen = t.kernel(trace_name)
    launched = r.window.launches.get(kernel, 0)
    if not launched or sec <= 0:
        return None
    if seen != launched:
        print(f"jxlbench: the trace holds {seen} of the window's {launched}"
              f" launches of {kernel}: no {kernel}_roofline", file=sys.stderr)
        return None
    nbytes = r.image_bytes[kernel] * len(r.window.images)
    return 100.0 * nbytes / r.peaks["hbm_bytes_per_s"] / sec
