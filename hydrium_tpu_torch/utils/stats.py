"""Per-encode observability: stage timers, section sizes, throughput.

The port's copy of hydrium_tpu/utils/stats.py, with its profiler hook
(device_trace) over torch.profiler.  The reference has none of this
beyond stderr prints; here every encode can carry an EncodeStats that
stages report into."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class EncodeStats:
    pixels: int = 0
    bytes_out: int = 0
    hf_symbols: int = 0
    stage_seconds: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    section_sizes: List[int] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    last_error: Optional[str] = None
    # opt-in cross-thread event timeline: (stage, t0, t1, thread-name)
    # tuples, filled by stage() when enabled via enable_timeline()
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

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.stage_seconds[name] += t1 - t0
                if self.events is not None:
                    self.events.append(
                        (name, t0, t1, threading.current_thread().name))

    @contextlib.contextmanager
    def event(self, name: str):
        """Timeline-only span (no stage_seconds aggregation); no-op
        unless enable_timeline() was called."""
        if self.events is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.events.append(
                    (name, t0, t1, threading.current_thread().name))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    @property
    def mpixels_per_sec(self) -> float:
        total = sum(self.stage_seconds.values())
        return self.pixels / total / 1e6 if total else 0.0

    def summary(self) -> str:
        lines = [f"pixels={self.pixels} bytes={self.bytes_out} "
                 f"bpp={8*self.bytes_out/max(self.pixels,1):.3f} "
                 f"symbols={self.hf_symbols}"]
        for k, v in sorted(self.stage_seconds.items(),
                           key=lambda kv: -kv[1]):
            lines.append(f"  {k:<24} {v*1e3:9.1f} ms")
        for k, v in sorted(self.counters.items()):
            lines.append(f"  {k:<24} {v}")
        if self.last_error:
            lines.append(f"  last_error: {self.last_error}")
        return "\n".join(lines)



@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Wrap a region in a torch.profiler trace when log_dir is given
    (a no-op otherwise): CPU activity always, CUDA activity where a card
    is present.  The Chrome trace is written to
    log_dir/trace_<pid>_<n>.json when the region ends; the context
    yields that path (None when off)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    n = 0
    while os.path.exists(path := os.path.join(
            log_dir, f"trace_{os.getpid()}_{n}.json")):
        n += 1
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
