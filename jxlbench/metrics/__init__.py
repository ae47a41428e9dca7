"""Per-layer metric readers, one file each, found by the metric's name.

Each file defines read(r) -> float or None, where r is a run.Reading: the
window (loop.Window), its trace (trace.Trace, or None without a card),
the kernel bytes of one image (kernels.image_bytes) and the device's
peaks.  A reader that finds nothing to read returns None, and the metric
is left out of the run's line."""
