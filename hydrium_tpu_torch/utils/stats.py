"""Per-encode observability: stage timers, counters and a span timeline.

The port's copy of hydrium_tpu/utils/stats.py, with its profiler hook
(device_trace) over torch.profiler.  The reference has none of this
beyond stderr prints; here every encode can carry an EncodeStats that
stages report into.

A span is one `stage` or `event`.  Its tag, where it has one, is the
(y, x) of the LF group or tile unit it works for: every span of one LF
group shares it, across the threads that serve it, and a span's parent
is the span of the same thread that encloses it.  With the timeline on,
each span is also an event (name[y,x], t0, t1, thread) on
time.perf_counter(), and while a torch.profiler records, a
torch.profiler.record_function of that name as well: the program's
spans then sit in the profiler's own trace, on the clock of the device's
kernels.

A job's wait in a queue (`queued`) opens on the thread that queues it
and closes on the thread that runs it: its event and its mirror sit on
the queueing thread's row."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def _label(name: str, tag) -> str:
    return name if tag is None else f"{name}[{tag[0]},{tag[1]}]"


class _Span:
    """The context of one stage or event (see EncodeStats.stage)."""

    __slots__ = ("stats", "name", "tag", "sums", "label", "mirror", "t0")

    def __init__(self, stats: "EncodeStats", name: str, tag, sums: bool):
        self.stats, self.name, self.tag, self.sums = stats, name, tag, sums

    def __enter__(self):
        self.label = self.mirror = None
        if self.stats.events is not None:
            self.label = _label(self.name, self.tag)
            if _autograd_profiler._is_profiler_enabled:
                self.mirror = record_function(self.label)
                self.mirror.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        st = self.stats
        with st._lock:
            if self.sums:
                st.stage_seconds[self.name] += t1 - self.t0
            if self.label is not None and st.events is not None:
                st.events.append((self.label, self.t0, t1,
                                  threading.current_thread().name))


class _Queued:
    """A job's wait in a queue (see EncodeStats.queued): opened where the
    job is queued, closed by close() on the thread that runs it."""

    __slots__ = ("stats", "name", "label", "thread", "done", "t0")

    def __init__(self, stats: "EncodeStats", name: str, tag):
        self.stats, self.name = stats, name
        self.label = self.thread = self.done = None
        if stats.events is not None:
            self.label = _label(name, tag)
            self.thread = threading.current_thread().name
            if _autograd_profiler._is_profiler_enabled:
                # the profiler's own span for work that ends elsewhere:
                # it opens here and ends when `done` completes
                import torch

                self.done = torch.futures.Future()
                rec = torch.ops.profiler._record_function_enter_new(
                    self.label, None)
                torch.ops.profiler._call_end_callbacks_on_jit_fut.\
                    _RecordFunction(rec, self.done)
        self.t0 = time.perf_counter()

    def close(self) -> None:
        t1 = time.perf_counter()
        if self.done is not None:
            self.done.set_result(None)
        st = self.stats
        with st._lock:
            st.stage_seconds[self.name] += t1 - self.t0
            if self.label is not None and st.events is not None:
                st.events.append((self.label, self.t0, t1, self.thread))


@dataclass
class EncodeStats:
    pixels: int = 0
    bytes_out: int = 0
    stage_seconds: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counters: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    # opt-in cross-thread event timeline: (stage[y,x], t0, t1, thread-name)
    # tuples, filled by stage() and event() when enabled via
    # enable_timeline()
    events: Optional[List] = field(default=None, repr=False, compare=False)
    # counters/stages are updated from prefetch worker threads too
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def enable_timeline(self) -> None:
        self.events = []

    def timeline(self) -> str:
        """Render the event log as a per-thread Gantt-ish text table
        (times relative to the first event, ms)."""
        if not self.events:
            return "(timeline disabled or empty)"
        ev = sorted(self.events, key=lambda e: e[1])
        t_base = ev[0][1]
        lines = ["  t0_ms    t1_ms    dur_ms  thread           stage"]
        for name, t0, t1, thr in ev:
            lines.append(f"  {1e3*(t0-t_base):8.1f} {1e3*(t1-t_base):8.1f} "
                         f"{1e3*(t1-t0):8.1f}  {thr:<16} {name}")
        return "\n".join(lines)

    def stage(self, name: str, tag=None) -> _Span:
        """Time a span into stage_seconds[name] (summed over threads);
        with the timeline on, also record it as the event name[y,x],
        tag being the (y, x) of its LF group or tile unit, and mirror it
        into a running torch.profiler.  Off, it costs two clock reads
        and a lock."""
        return _Span(self, name, tag, True)

    def event(self, name: str, tag=None):
        """Timeline-only span (no stage_seconds aggregation), tagged as
        stage() tags; a no-op unless enable_timeline() was called."""
        if self.events is None:
            return _OFF
        return _Span(self, name, tag, False)

    def queued(self, name: str, tag=None) -> _Queued:
        """Time a job's wait in a queue into stage_seconds[name]: from
        here, where it is queued, to close(), called first thing on the
        thread that runs it.  Tagged, logged and mirrored as stage()
        does, on this thread's row."""
        return _Queued(self, name, tag)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def summary(self) -> str:
        lines = [f"pixels={self.pixels} bytes={self.bytes_out} "
                 f"bpp={8*self.bytes_out/max(self.pixels,1):.3f}"]
        for k, v in sorted(self.stage_seconds.items(),
                           key=lambda kv: -kv[1]):
            lines.append(f"  {k:<24} {v*1e3:9.1f} ms")
        for k, v in sorted(self.counters.items()):
            lines.append(f"  {k:<24} {v}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Wrap a region in a torch.profiler trace when log_dir is given
    (a no-op otherwise): CPU activity of every thread always, CUDA
    activity where a card is present, and the spans of every
    EncodeStats whose timeline is on, each on its own thread's row.
    The Chrome trace is written to log_dir/trace_<pid>_<n>.json when the
    region ends; the context yields that path (None when off)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    n = 0
    while os.path.exists(path := os.path.join(
            log_dir, f"trace_{os.getpid()}_{n}.json")):
        n += 1
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # the encoder's worker threads (hyd-prep, hyd-fetch, hyd-drain,
    # hyd-tile) are recorded too, not only the thread that opened it
    with profile(activities=activities, experimental_config=
                 _ExperimentalConfig(profile_all_threads=True)) as prof:
        yield path
    prof.export_chrome_trace(path)
