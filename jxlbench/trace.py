"""Reading a torch.profiler trace of the measured window: the device's
busy time (the union of its operations' intervals), each kernel's device
time by name, the operations with the most device time, and the longest
idle gaps, each labelled by the host event that was open at its middle
(the EncodeStats timeline of the image being encoded)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARKER = "jxlbench.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    # device operation name -> (seconds, count), over the window
    ops: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    # (seconds, label) of the idle gaps, longest first, at most `keep`
    gaps: List[Tuple[float, str]] = field(default_factory=list)

    def kernel(self, name: str) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        `name`."""
        s, n = 0.0, 0
        for op, (sec, cnt) in self.ops.items():
            if name in op:
                s += sec
                n += cnt
        return s, n

    def top_ops(self, k: int = 10) -> List[list]:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:k]
        return [[short_name(name), sec] for name, (sec, _) in top]


def short_name(name: str) -> str:
    name = re.sub(r"[^A-Za-z0-9_:.]+", "_", name)
    return name[:64]


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def label_at(t: float, host_events) -> str:
    """The host event open at time t that started last, its bracketed
    arguments dropped ("dispatch[0,1]" -> "dispatch"); "host" if none."""
    best = None
    for name, t0, t1, _thread in host_events:
        if t0 <= t <= t1 and (best is None or t0 > best[1]):
            best = (name, t0)
    return best[0].split("[")[0] if best else "host"


def gaps_of(busy: List[Tuple[float, float]], w0: float, w1: float):
    """Idle intervals of [w0, w1] outside the merged busy intervals."""
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, min(a, w1)))
        t = max(t, b)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(a, b) for a, b in out if b > a]


def read(events, host_events, window_start: float, window_s: float,
         keep: int = 10) -> Optional[Trace]:
    """events: the profiler's FunctionEvents; host_events: (name, t0,
    t1, thread) on the host clock (time.perf_counter); window_start: the
    host clock when the MARKER span opened.  None if the marker is
    missing."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    marker = [e for e in events if e.name == MARKER
              and e.device_type != cuda]
    if not marker:
        return None
    m0 = marker[0].time_range.start / 1e6
    w0, w1 = m0, m0 + window_s
    ops: Dict[str, list] = {}
    spans = []
    for e in events:
        # a record_function span is mirrored on the device's timeline as
        # a user annotation over the kernels it holds: not an operation
        if e.device_type != cuda or e.name == MARKER or \
                getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        spans.append((a, b))
        rec = ops.setdefault(e.name, [0.0, 0])
        rec[0] += b - a
        rec[1] += 1
    busy = merge(spans)
    idle = sorted(gaps_of(busy, w0, w1), key=lambda g: g[0] - g[1])[:keep]
    shift = window_start - m0
    gaps = [(b - a, label_at((a + b) / 2 + shift, host_events))
            for a, b in idle]
    return Trace(window_s=window_s, busy_s=sum(b - a for a, b in busy),
                 ops={k: (v[0], v[1]) for k, v in ops.items()}, gaps=gaps)
