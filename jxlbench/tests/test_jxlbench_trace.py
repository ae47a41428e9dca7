"""Busy time, kernel time by name and idle-gap labels, from a synthetic
profiler trace and host timeline."""

import types

import pytest
import torch

from jxlbench import trace as T

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _ev(name, a_us, b_us, dev=CUDA):
    return types.SimpleNamespace(
        name=name, device_type=dev,
        time_range=types.SimpleNamespace(start=a_us, end=b_us))


def test_busy_kernels_and_labelled_gaps():
    # marker at trace time 1.0 s; window 1.0 s; host clock = trace + 99
    events = [_ev(T.MARKER, 1_000_000, 2_000_000, CPU),
              _ev(T.MARKER, 1_000_000, 2_000_000),
              _ev("transport_prep_kernel", 1_100_000, 1_150_000),
              _ev("chunk_pack_streams_kernel", 1_140_000, 1_200_000),
              _ev("void at::native::copy", 1_600_000, 1_700_000),
              _ev("outside", 2_500_000, 2_600_000)]
    host = [("prepare", 100.0, 100.5, "hyd-prep_0"),
            ("dispatch[0,1]", 100.3, 100.45, "hyd-prep_0"),
            ("walk", 100.7, 101.0, "drain")]
    tr = T.read(events, host, window_start=100.0, window_s=1.0)
    assert tr.busy_s == pytest.approx(0.2)
    assert tr.kernel("transport_prep") == (pytest.approx(0.05), 1)
    assert "outside" not in tr.ops
    # gaps: [1.0,1.1] prepare, [1.2,1.6] mid 1.4 -> dispatch open since
    # 100.3 (latest start), [1.7,2.0] mid 1.85 -> walk
    assert [(round(s, 6), lab) for s, lab in tr.gaps] == [
        (0.4, "dispatch"), (0.3, "walk"), (0.1, "prepare")]
    assert tr.top_ops(1)[0][0] == "void_at::native::copy"


def test_no_marker_no_trace():
    assert T.read([_ev("k", 0, 1)], [], 0.0, 1.0) is None


def test_label_outside_every_event_is_host():
    assert T.label_at(5.0, [("walk", 1.0, 2.0, "t")]) == "host"


def _reading(seen, launched):
    from jxlbench import run

    tr = T.Trace(window_s=1.0, busy_s=0.1,
                 ops={"transport_prep_kernel": (0.001, seen)})
    win = types.SimpleNamespace(launches={"transport_prep": launched},
                                images=[object()])
    return run.Reading(win, tr, {"transport_prep": 3_350_000},
                       {"hbm_bytes_per_s": 3.35e12})


def test_roofline_reads_a_trace_that_holds_every_launch():
    from jxlbench.metrics._roofline import share

    assert share(_reading(4, 4), "transport_prep",
                 "transport_prep_kernel") == pytest.approx(0.1)


@pytest.mark.parametrize("seen", [0, 3, 5])
def test_roofline_is_silent_where_the_trace_lost_or_gained_launches(seen):
    from jxlbench.metrics._roofline import share

    assert share(_reading(seen, 4), "transport_prep",
                 "transport_prep_kernel") is None
