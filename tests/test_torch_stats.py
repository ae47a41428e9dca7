"""The port's profiler hook, utils/stats.py::device_trace (twin of the
JAX package's jax.profiler wrapper), on the CPU."""

import json
import threading

import numpy as np
import pytest

import hydrium_tpu_torch
from hydrium_tpu_torch.utils.stats import device_trace
from test_e2e import make_image
from test_torch_e2e import warm_state  # noqa: F401 (autouse fixture)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """A small encode inside the trace: one Chrome trace file under
    log_dir, holding the encode's torch operators."""
    img = make_image(64, 300, "noise", seed=4)
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)) as path:
        data = hydrium_tpu_torch.encode_image(img, device="cpu")
    assert data[:2] == b"\xff\x0a"
    files = sorted(p.name for p in log_dir.iterdir())
    assert files == [path.split("/")[-1]] and files[0].endswith(".json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    with device_trace(str(log_dir)) as second:
        np.zeros(1)
    assert second != path and len(list(log_dir.iterdir())) == 2


@pytest.mark.parametrize("log_dir", [None, ""])
def test_device_trace_is_a_no_op_without_a_directory(log_dir, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    with device_trace(log_dir) as path:
        pass
    assert path is None
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("shift", [-1, 0])
def test_link_byte_counters(shift, monkeypatch):
    """h2d_raw_bytes covers every pixel uploaded, fetched_words at least
    the stream words each payload said it needed, one-frame and tiled."""
    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch import host

    needed = []
    real = host.packed_need_words

    def spy(aux):
        needed.append(real(aux))
        return needed[-1]

    monkeypatch.setattr(host, "packed_need_words", spy)
    h, w = 300, 520
    img = make_image(h, w, "noise", seed=9)
    stats = EncodeStats()
    data = hydrium_tpu_torch.encode_image(img, shift, device="cpu",
                                          stats=stats)
    assert data[:2] == b"\xff\x0a"
    c = stats.counters
    assert c["lfg_packed"] == len(needed) > 0
    assert c["h2d_raw_bytes"] >= h * w * 3
    assert c["fetched_words"] >= sum(needed) + len(needed)


# -- the spans of the host paths, tagged per LF group or tile ----------

ONE_FRAME = (64, 2100)      # two LF groups, (0,0) and (0,1)


def _events_by_tag(stats):
    """{tag: [(name, t0, t1, thread), ...] by start} of the tagged
    events, name without its tag."""
    out = {}
    for name, t0, t1, thread in stats.events:
        if "[" in name:
            base, tag = name[:-1].split("[")
            out.setdefault(tag, []).append((base, t0, t1, thread))
    return {k: sorted(v, key=lambda e: e[1]) for k, v in out.items()}


def test_stage_tags_its_event_and_sums_under_its_name():
    from hydrium_tpu_torch import EncodeStats

    stats = EncodeStats()
    with stats.stage("walk", (1, 2)), stats.event("h2d", (1, 2)):
        pass
    with stats.event("h2d", (3, 4)):
        pass                        # timeline off: nothing recorded
    assert stats.events is None and set(stats.stage_seconds) == {"walk"}
    stats.enable_timeline()
    with stats.stage("walk", (1, 2)), stats.event("h2d", (0, 5)):
        pass
    with stats.stage("ans_encode"):
        pass
    assert [e[0] for e in stats.events] == ["h2d[0,5]", "walk[1,2]",
                                            "ans_encode"]
    assert set(stats.stage_seconds) == {"walk", "ans_encode"}
    for ev in stats.events:
        assert len(ev) == 4 and ev[1] <= ev[2]
        assert ev[3] == threading.current_thread().name


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_one_frame_spans_and_counters_of_each_lf_group(cold, monkeypatch,
                                                      tmp_path):
    """Each LF group's tag: one drain_wait, parse and walk on hyd-drain,
    in that order, within its pipeline+transfer; its codec tables on
    hyd-prep (a cold codec's bootstrap re-dispatch on hyd-fetch); an
    aux_wait and a codec_fold on hyd-fetch; the caller's dispatch and
    fetch_wait.  dispatches counts every _dispatch call and
    codec_table_builds every build of the tables."""
    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch import encoder as TE
    from hydrium_tpu_torch.jxl import native, tokcode

    if cold:
        TE.reset_warm_state(tmp_path / "cold" / "warm.npz")
    else:
        # built before the encode: dispatches reuse them until a fold
        # clears them
        TE._SHARED_CODEC.tables()
    calls = {"dispatch": 0, "build": 0}
    real_dispatch = TE._TorchDispatch._dispatch

    def dispatch(self):
        calls["dispatch"] += 1
        return real_dispatch(self)

    def counted(real_build):
        def build(freqs):
            calls["build"] += 1
            return real_build(freqs)
        return build

    monkeypatch.setattr(TE._TorchDispatch, "_dispatch", dispatch)
    # tables() builds with the native plane, or with its Python twin
    # where the native plane is missing: count both
    monkeypatch.setattr(tokcode, "build_tables",
                        counted(tokcode.build_tables))
    monkeypatch.setattr(native, "tok_build_tables",
                        counted(native.tok_build_tables))
    stats = EncodeStats()
    stats.enable_timeline()
    img = make_image(*ONE_FRAME, "noise", seed=21)
    assert hydrium_tpu_torch.encode_image(img, device="cpu",
                                          stats=stats)[:2] == b"\xff\x0a"
    c = stats.counters
    assert c["dispatches"] == calls["dispatch"] == 2 + c["codec_bootstraps"] \
        + c["wide_retries"]
    assert c["codec_bootstraps"] == int(cold)
    assert c.get("codec_table_builds", 0) == calls["build"]
    if cold:
        assert calls["build"] > 0
    else:       # its first dispatch reuses the tables built before
        assert calls["build"] < c["dispatches"]
    caller = threading.current_thread().name
    by_tag = _events_by_tag(stats)
    assert set(by_tag) == {"0,0", "0,1"}
    tables = []
    for tag, evs in by_tag.items():
        drain = [e for e in evs if e[3].startswith("hyd-drain")]
        assert [e[0] for e in drain if e[0] in ("drain_wait", "parse",
                                                "walk")] == [
            "drain_wait", "parse", "walk"], (tag, drain)
        outer = [e for e in drain if e[0] == "pipeline+transfer"]
        assert len(outer) == 1
        assert all(outer[0][1] <= e[1] <= e[2] <= outer[0][2]
                   for e in drain if e[0] in ("drain_wait", "parse", "walk"))
        on = {}
        for name, _t0, _t1, thread in evs:
            on.setdefault(name, []).append(thread)
        assert sum(t.startswith("hyd-prep") for t in on["codec_tables"]) \
            == 1, (tag, on)
        tables += on["codec_tables"]
        assert "hyd-fetch" in on["aux_wait"]
        assert "hyd-fetch" in on["codec_fold"]
        assert on["fetch_wait"] == [caller]
        assert caller in on["dispatch"]
    assert len(tables) == c["dispatches"]
    assert sum(t == "hyd-fetch" for t in tables) == \
        c["codec_bootstraps"] + c["wide_retries"]
    # the prep workers' code tables lie inside their prepare
    assert sum(t1 - t0 for n, t0, t1, th in stats.events
               if n.startswith("codec_tables[") and th.startswith("hyd-prep")
               ) <= stats.stage_seconds["prepare"]


@pytest.mark.parametrize("h,w", [(512, 768), (300, 700)],
                         ids=["full_tiles", "edge_tiles"])
def test_tiled_encode_renders_each_tile_once(h, w):
    """One render per tile, tagged with its (y, x): on hyd-tile, with
    its walk inside it and one render_queue from the unit's fetch thread
    ending where it starts, for a stacked chunk's tiles; on the caller
    for an edge tile, whose walk runs in its drain.  tile_frames counts
    every tile."""
    from hydrium_tpu_torch import EncodeStats

    stats = EncodeStats()
    stats.enable_timeline()
    img = make_image(h, w, "noise", seed=h + w)
    hydrium_tpu_torch.encode_image(img, 0, device="cpu", stats=stats)
    tiles = {f"{ty},{tx}" for ty in range((h + 255) // 256)
             for tx in range((w + 255) // 256)}
    full = {f"{ty},{tx}" for ty in range(h // 256) for tx in range(w // 256)}
    by_tag = _events_by_tag(stats)
    renders = {tag: [e for e in evs if e[0] == "render"]
               for tag, evs in by_tag.items()}
    assert {t for t, r in renders.items() if r} == tiles
    caller = threading.current_thread().name
    for tag in tiles:
        (_n, t0, t1, thread), = renders[tag]
        walks = [e for e in by_tag[tag] if e[0] == "walk"]
        assert len(walks) == 1
        queues = [e for e in by_tag[tag] if e[0] == "render_queue"]
        if tag in full:
            assert thread.startswith("hyd-tile")
            assert walks[0][3] == thread and t0 <= walks[0][1] <= t1
            (_n, q0, q1, queuer), = queues
            assert queuer.startswith("hyd-fetch") and q0 <= q1 <= t0
        else:
            assert thread == caller and queues == []
    assert sum(len(r) for r in renders.values()) == len(tiles)
    assert stats.counters["tile_frames"] == len(tiles)


@pytest.mark.parametrize("shift", [-1, 0], ids=["one_frame", "tiled"])
def test_files_equal_with_the_timeline_on_and_off(shift):
    from hydrium_tpu_torch import EncodeStats

    img = make_image(*ONE_FRAME, "noise", seed=22)
    files = []
    for timeline in (False, True):
        stats = EncodeStats()
        if timeline:
            stats.enable_timeline()
        files.append(hydrium_tpu_torch.encode_image(img, shift, device="cpu",
                                                    stats=stats))
    assert files[0] == files[1]
    assert stats.events and all(len(e) == 4 for e in stats.events)


@pytest.mark.parametrize("shift,shape,worker",
                         [(-1, ONE_FRAME, "hyd-drain"),
                          (0, (300, 700), "hyd-tile")],
                         ids=["one_frame", "tiled"])
def test_spans_are_mirrored_in_the_profilers_trace(shift, shape, worker,
                                                   tmp_path):
    """Under device_trace (a torch.profiler of every thread), each event
    of the timeline has a user annotation of the same name in the Chrome
    trace, as often, and each profiler thread holds the spans of one
    thread name: the spans sit on their own threads' rows."""
    from collections import Counter

    from hydrium_tpu_torch import EncodeStats

    img = make_image(*shape, "noise", seed=23)
    stats = EncodeStats()
    stats.enable_timeline()
    with device_trace(str(tmp_path)) as path:
        hydrium_tpu_torch.encode_image(img, shift, device="cpu", stats=stats)
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    mine = Counter(e[0] for e in stats.events)
    mirrored = [e for e in trace if e.get("ph") == "X"
                and e.get("cat") == "user_annotation" and e["name"] in mine]
    assert Counter(e["name"] for e in mirrored) == mine
    names_of_tid = {}
    once = {n for n, k in mine.items() if k == 1}
    for name, _t0, _t1, thread in stats.events:
        if name in once:
            tid, = [e["tid"] for e in mirrored if e["name"] == name]
            names_of_tid.setdefault(tid, set()).add(thread)
    assert all(len(v) == 1 for v in names_of_tid.values()), names_of_tid
    threads = {t for v in names_of_tid.values() for t in v}
    assert threading.current_thread().name in threads
    assert any(t.startswith("hyd-prep") for t in threads)
    assert any(t.startswith(worker) for t in threads)


def test_render_queue_is_mirrored_under_a_profiler(tmp_path):
    """A tile's render_queue opens on the fetch thread and ends on a
    hyd-tile worker: under device_trace with the timeline on, each is a
    user annotation of its own name[y,x] in the profiler's trace."""
    from hydrium_tpu_torch import EncodeStats

    stats = EncodeStats()
    stats.enable_timeline()
    img = make_image(512, 768, "noise", seed=25)
    with device_trace(str(tmp_path)) as path:
        hydrium_tpu_torch.encode_image(img, 0, device="cpu", stats=stats)
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    want = sorted(f"render_queue[{ty},{tx}]" for ty in range(2)
                  for tx in range(3))
    assert sorted(e[0] for e in stats.events
                  if e[0].startswith("render_queue")) == want
    assert sorted(e["name"] for e in trace if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith("render_queue")) == want


@pytest.mark.parametrize("timeline,profiling", [(True, False),
                                                (False, True)],
                         ids=["no_profiler", "no_timeline"])
def test_no_record_function_unless_both_are_on(timeline, profiling,
                                               monkeypatch, tmp_path):
    """record_function is entered only while the timeline is on and a
    profiler records: with either off it is never made."""
    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch.utils import stats as S

    made = []
    monkeypatch.setattr(S, "record_function",
                        lambda name: made.append(name))
    stats = EncodeStats()
    if timeline:
        stats.enable_timeline()
    img = make_image(*ONE_FRAME, "noise", seed=24)
    with device_trace(str(tmp_path) if profiling else None):
        hydrium_tpu_torch.encode_image(img, device="cpu", stats=stats)
    assert made == [] and stats.stage_seconds["walk"] > 0
