"""The port's compile-once dispatch (hydrium_tpu_torch/ops/graphs.py) on
the CPU: its static key, the graph cache's first eager dispatch and
capture at the second, its memory budget, eviction order and launch
accounting under an injected stub capture and eager run, the refusal of
a CPU tensor; and the packed pipeline's rewrites for capture (the fixed-bin LF
histogram, the expanded presets and extent mask, the scatter-add
cluster histogram) against the forms they replace and the JAX
package.  The graphs themselves run only on a card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hydrium_tpu_torch
from hydrium_tpu.ops import pipeline as P
from hydrium_tpu.ops import tables as jax_tables
from hydrium_tpu_torch import ImageMetadata
from hydrium_tpu_torch import encoder as TE
from hydrium_tpu_torch.ops import bitpack as TB
from hydrium_tpu_torch.ops import front as TF
from hydrium_tpu_torch.ops import frontend as TFE
from hydrium_tpu_torch.ops import graphs as TG
from hydrium_tpu_torch.ops import packed as TP
from hydrium_tpu_torch.ops import transport as TT
from test_torch_e2e import warm_state  # noqa: F401

WRAPPERS = (TT.transport_prep, TB.pack_chunks, TFE.frontend_tokens,
            TFE.frontend_groups)
FRONT = TF.FrontEnd.from_tables()
BASE = dict(buf_h=2048, buf_w=2048, linear_light=False, sample_kind="uint8",
            lf_seg_vb=0, tok_classes=9, wide_residues=False, fused=False)


def _key(lfg, dtype=torch.uint8, device="meta", **kw):
    """The key of a dispatch of LF group `lfg`, shaped as _TorchDispatch
    shapes it (a meta tensor stands for the upload)."""
    buf_h, buf_w, uh, uw = TE.buffer_shapes(lfg)
    px = torch.empty((uh, uw, 3), dtype=dtype, device=device)
    args = dict(BASE, buf_h=buf_h, buf_w=buf_w)
    args.update(kw)
    return TG.packed_key(FRONT, px, lfg.height, lfg.width, **args)


def _one_frame_lfgs(w, h):
    enc = hydrium_tpu_torch.Encoder(ImageMetadata(width=w, height=h),
                                    device="cpu")
    try:
        return list(enc._geo.lf_groups)
    finally:
        enc.close()


@pytest.mark.parametrize("w,h,n_keys", [(3840, 2160, 4),
                                        (16384, 16384, 1),
                                        (16384, 16385, 2)])
def test_key_is_shared_by_lf_groups_of_one_shape(w, h, n_keys):
    """Two calls give each LF group the same key; a 4K frame has four
    LF-group shapes, a 16384^2 frame one for all 64 LF groups, and one
    row more adds the 1-row bottom LF groups' key."""
    keys = [[_key(lfg) for lfg in _one_frame_lfgs(w, h)] for _ in range(2)]
    assert keys[0] == keys[1]
    assert len(set(keys[0])) == n_keys


def test_key_is_shared_by_the_edge_tiles_of_a_row():
    """Tiled 4K: the bottom row's 15 edge tiles (112x256) share a key."""
    meta = ImageMetadata(width=3840, height=2160, tile_size_shift_x=0,
                         tile_size_shift_y=0)
    enc = hydrium_tpu_torch.Encoder(meta, device="cpu")
    try:
        edges = [enc._tile_geometry(tx, 8) for tx in range(15)]
    finally:
        enc.close()
    assert {(g.height, g.width) for g in edges} == {(112, 256)}
    assert len({_key(g, lf_seg_vb=0, fused=True) for g in edges}) == 1


_LFG = TE.LFGroupGeometry(x=0, y=0, width=2048, height=2048,
                          tile_count_x=8, tile_count_y=8)
_VARIANTS = {
    "buffer_shape": dict(buf_h=4096, buf_w=256),
    "upload_shape": dict(_upload=(1024, 2048)),
    "dtype": dict(_dtype=torch.uint16),
    "fused": dict(fused=True),
    "wide_residues": dict(wide_residues=True),
    "lf_seg_vb": dict(lf_seg_vb=32),
    "height_width": dict(_extent=(2040, 2048)),
    "linear_light": dict(linear_light=True),
    "sample_kind": dict(sample_kind="uint16"),
    "tok_classes": dict(tok_classes=3),
    "device": dict(_device="cpu"),
    "front": dict(_front="other tables"),
}


@pytest.mark.parametrize("what", sorted(_VARIANTS))
def test_key_differs_in_every_static_argument(what):
    v = dict(_VARIANTS[what])
    px = torch.empty(v.pop("_upload", (2048, 2048)) + (3,),
                     dtype=v.pop("_dtype", torch.uint8),
                     device=v.pop("_device", "meta"))
    h, w = v.pop("_extent", (2048, 2048))
    front = FRONT
    if v.pop("_front", None):
        tabs = dict(FRONT.named_buffers())
        front = TF.FrontEnd(**dict(tabs, lf_shift=tabs["lf_shift"] * 2))
    assert TG.packed_key(front, px, h, w, **dict(BASE, **v)) != _key(_LFG)


def test_key_is_shared_by_fronts_with_equal_tables():
    """Every Encoder makes its own FrontEnd.from_tables(): they share
    one digest, and so each key's graph."""
    a, b = TF.FrontEnd.from_tables(), TF.FrontEnd.from_tables()
    assert a is not b and a.digest == b.digest == FRONT.digest
    px = torch.empty((2048, 2048, 3), dtype=torch.uint8, device="meta")
    assert TG.packed_key(a, px, 2048, 2048, **BASE) == TG.packed_key(
        b, px, 2048, 2048, **BASE)


LAUNCHES = (1, 1, 1, 0)


def stub_eager(front, pixels, height, width, presets, tok_len, tok_code,
               **kw):
    """The eager body for the CPU: it launches once each, as the packed
    pipeline with the fused front does."""
    for f, n in zip(WRAPPERS, LAUNCHES):
        f.launches += n
    return pixels.sum().reshape(1) + tok_len.sum()


class StubGraph:
    """A capture for the CPU: it moves the launch counters as a capture
    does (once each; with `fail`, part way and then raises) and records
    its replays.  Its reserved memory is `reserved_mib[height]`, 3 MiB
    where not given."""

    launches = LAUNCHES
    fail = False
    reserved_mib: dict = {}

    def __init__(self, front, pixels, height, width, presets, tok_len,
                 tok_code, *, stream, **kw):
        assert stream is None           # no side stream on the CPU
        for f, n in zip(WRAPPERS, self.launches):
            f.launches += n
        if self.fail:
            raise RuntimeError("capture failed")
        self.key = TG.packed_key(front, pixels, height, width, **kw)
        self.capture_s = 0.25
        self.reserved_bytes = self.reserved_mib.get(height, 3) << 20
        self.replayed, self.closed = [], False

    def replay(self, pixels, presets, tok_len, tok_code):
        self.replayed.append((pixels, presets, tok_len, tok_code))
        return pixels.sum().reshape(1) + tok_len.sum()

    def close(self):
        self.closed = True


def _run(cache, height, *, pixels=None, tok_len=None):
    px = torch.zeros((32, 32, 3), dtype=torch.uint8) if pixels is None \
        else pixels
    tl = torch.zeros(640, dtype=torch.int32) if tok_len is None else tok_len
    return cache.run(FRONT, px, height, 32, torch.zeros(1, dtype=torch.int32),
                     tl, torch.zeros(640, dtype=torch.int32),
                     **dict(BASE, buf_h=256, buf_w=256))


def _live(cache):
    return [g["key"].split(" ")[0] for g in cache.stats()["cpu"]["graphs"]]


def _cache(**kw):
    return TG.GraphCache(capture=StubGraph, eager=stub_eager, **kw)


def _twice(cache, height):
    """Dispatch a key twice: eagerly, then captured and replayed."""
    _run(cache, height)
    _run(cache, height)
    lru = cache._graphs[torch.device("cpu")]
    return lru[next(reversed(lru))]


def test_cache_runs_a_key_eagerly_first_and_captures_it_second():
    """A key dispatched once makes no graph; its second dispatch
    captures and replays, its third replays."""
    cache = _cache()
    _run(cache, 30)
    _run(cache, 31)
    st = cache.stats()["cpu"]
    assert (st["eager"], st["captures"], st["replays"], st["live"]) == (
        2, 0, 0, 0)
    _run(cache, 30)
    graph, = cache._graphs[torch.device("cpu")].values()
    _run(cache, 30)
    st = cache.stats()["cpu"]
    assert (st["eager"], st["captures"], st["replays"], st["live"]) == (
        2, 1, 2, 1)
    assert len(graph.replayed) == 2
    assert _live(cache) == ["30x32"]


def test_cache_evicts_the_least_recently_used_graph(monkeypatch):
    """The budget bounds the live graphs' reserved memory: past it the
    least recently used leave, and the newest stays even alone above
    it."""
    monkeypatch.setattr(StubGraph, "reserved_mib",
                        {30: 4, 31: 4, 29: 4, 28: 20})
    cache = _cache(budget=10 << 20)
    graphs = {h: _twice(cache, h) for h in (30, 31)}
    _run(cache, 30)                 # 30 is now the most recently used
    graphs[29] = _twice(cache, 29)  # 12 MiB: evicts 31
    assert graphs[31].closed and not graphs[30].closed
    assert _live(cache) == ["30x32", "29x32"]
    _twice(cache, 31)               # captured again; evicts 30
    assert graphs[30].closed
    assert _live(cache) == ["29x32", "31x32"]
    _twice(cache, 28)               # 20 MiB alone: the others leave
    assert _live(cache) == ["28x32"]
    st = cache.stats()["cpu"]
    assert {k: st[k] for k in ("captures", "replays", "evictions", "live",
                               "reserved_mib")} == {
        "captures": 5, "replays": 6, "evictions": 4, "live": 1,
        "reserved_mib": 20.0}


def test_cache_stats_per_key():
    cache = _cache()
    assert cache.stats() == {}
    for h in (30, 30, 30, 31, 31, 32):
        _run(cache, h)
    st = cache.stats()["cpu"]
    d = FRONT.digest
    assert [(g["key"], g["replays"]) for g in st["graphs"]] == [
        (f"30x32 in 256x256 (upload 32x32 uint8) uint8 classes 9 front {d}",
         2),
        (f"31x32 in 256x256 (upload 32x32 uint8) uint8 classes 9 front {d}",
         1)]
    assert all(g["capture_s"] == 0.25 and g["reserved_mib"] == 3.0
               for g in st["graphs"])
    assert (st["eager"], st["reserved_mib"]) == (3, 6.0)


def test_cache_counts_the_captured_launches_on_every_replay():
    """The eager first dispatch counts its launches, the capture counts
    those its own replay makes, and each later replay adds the captured
    launches: n dispatches, n launches each."""
    cache = _cache()
    before = [f.launches for f in WRAPPERS]
    for n in range(1, 5):
        _run(cache, 30)
        assert [f.launches - b for f, b in zip(WRAPPERS, before)] == [
            n * d for d in LAUNCHES]
    assert cache.stats()["cpu"]["replays"] == 3


def test_cache_capture_error_reaches_the_caller(monkeypatch):
    """A failing capture raises to the caller, leaves no graph and none
    of its counts behind; the key's next dispatch runs eagerly and the
    one after captures anew."""
    cache = _cache()
    _run(cache, 30)
    before = [f.launches for f in WRAPPERS]
    monkeypatch.setattr(StubGraph, "fail", True)
    with pytest.raises(RuntimeError, match="capture failed"):
        _run(cache, 30)
    assert [f.launches for f in WRAPPERS] == before
    assert cache.stats()["cpu"]["live"] == 0
    monkeypatch.setattr(StubGraph, "fail", False)
    _twice(cache, 30)
    st = cache.stats()["cpu"]
    assert (st["eager"], st["captures"], st["replays"], st["live"]) == (
        2, 1, 1, 1)


def test_cache_replays_with_each_dispatch_inputs():
    """Each replay gets its own dispatch's inputs and returns what the
    graph made of them."""
    cache = _cache()
    outs = [_run(cache, 30, pixels=torch.full((32, 32, 3), v,
                                              dtype=torch.uint8),
                 tok_len=torch.full((640,), t, dtype=torch.int32))
            for v, t in ((1, 0), (2, 5), (3, 1))]
    assert [int(o) for o in outs] == [3072, 2 * 3072 + 3200, 3 * 3072 + 640]
    graph, = cache._graphs[torch.device("cpu")].values()
    assert [int(p.sum()) for p, *_ in graph.replayed] == [6144, 9216]


def test_cache_forgets_keys_seen_once_past_its_bound(monkeypatch):
    """Keys dispatched once are remembered up to SEEN a device: one
    pushed out runs eagerly again at its next dispatch."""
    monkeypatch.setattr(TG, "SEEN", 2)
    cache = _cache()
    for h in (30, 31, 32, 30):
        _run(cache, h)
    st = cache.stats()["cpu"]
    assert (st["eager"], st["captures"]) == (4, 0)
    _run(cache, 30)
    assert cache.stats()["cpu"]["captures"] == 1


def test_clear_closes_every_graph():
    cache = _cache()
    graphs = [_twice(cache, 30), _twice(cache, 31)]
    _run(cache, 32)
    cache.clear()
    assert all(g.closed for g in graphs)
    assert cache.stats()["cpu"]["live"] == 0
    _run(cache, 32)                 # forgotten: eager again
    assert cache.stats()["cpu"]["captures"] == 2


def test_graph_runner_refuses_a_cpu_tensor():
    px = torch.zeros((32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA graphs need pixels on a "
                       "CUDA device, not cpu"):
        TG.encode_lfg_packed(None, px, 32, 32,
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros(640, dtype=torch.int32),
                             torch.zeros(640, dtype=torch.int32),
                             **dict(BASE, buf_h=256, buf_w=256))


def test_cpu_encoder_makes_no_graph():
    img = np.random.default_rng(3).integers(0, 256, (200, 300, 3),
                                            dtype=np.uint8)
    assert hydrium_tpu_torch.encode_image(img, device="cpu")[:2] == \
        b"\xff\x0a"
    assert hydrium_tpu_torch.encode_image(img, 0, device="cpu")[:2] == \
        b"\xff\x0a"
    assert TG.graph_stats() == {}


# -- the rewrites that make the packed pipeline capturable --------------

@pytest.mark.parametrize("n,high", [(1, 1), (4097, 64), (30000, 20)])
def test_lf_histogram_equals_bincount(n, high):
    lf_t = torch.from_numpy(np.random.default_rng(n).integers(0, high, n))
    lf_t[0] = 63
    got = TP.lf_histogram(lf_t)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.bincount(lf_t, minlength=64))


@pytest.mark.parametrize("n,k", [(1, 3072), (64, 3072), (7, 3)])
def test_repeat_each_equals_repeat_interleave(n, k):
    x = torch.from_numpy(np.random.default_rng(k).integers(0, 256, n)
                         .astype(np.int32))
    assert torch.equal(TF.repeat_each(x, k), x.repeat_interleave(k))


def _extent_ok_replaced(height, width, buf_h, buf_w):
    """The extent mask as tokenize_lfg built it with repeat_interleave."""
    gcy, gcx = buf_h >> 8, buf_w >> 8
    vh, vw = (height + 7) >> 3, (width + 7) >> 3
    gbh = (vh - torch.arange(gcy) * 32).clamp(0, 32)
    gbw = (vw - torch.arange(gcx) * 32).clamp(0, 32)
    by = torch.arange(32)
    ok = ((by[None, :, None, None] < gbh[:, None, None, None])
          & (by[None, None, None, :] < gbw[None, None, :, None]))
    return ok.permute(0, 2, 1, 3).reshape(-1).repeat_interleave(3)


@pytest.mark.parametrize("height,width,buf_h,buf_w", [
    (2048, 2048, 2048, 2048), (112, 1792, 256, 1792),
    (300, 520, 512, 768), (1, 16384 - 14336, 256, 2048)])
def test_extent_mask_equals_the_replaced_form(height, width, buf_h, buf_w):
    got = TF.extent_ok(height, width, buf_h=buf_h, buf_w=buf_w,
                       device="cpu")
    assert torch.equal(got, _extent_ok_replaced(height, width, buf_h, buf_w))


def _hist_replaced(out, num_clusters):
    """cluster_histogram as an index_put_ with accumulate, the form the
    scatter-add replaces."""
    tokens = out["tokens"].to(torch.int64) & 0xFFFF
    mask = (torch.arange(64)[None, :]
            < out["valid_len"][:, None]).to(torch.int32)
    hist = torch.zeros((num_clusters, 128), dtype=torch.int32)
    hist.index_put_((out["clusters"].to(torch.int64), tokens.clamp(max=127)),
                    mask, accumulate=True)
    return hist


@pytest.mark.parametrize("n,num_clusters", [(3072, 9), (6144, 36)])
def test_cluster_histogram_equals_the_replaced_form(n, num_clusters):
    rng = np.random.default_rng(n)
    out = {"tokens": torch.from_numpy(rng.integers(
               -(1 << 15), 1 << 15, (n, 64)).astype(np.int16)),
           "clusters": torch.from_numpy(rng.integers(
               0, num_clusters, (n, 64)).astype(np.uint8)),
           "valid_len": torch.from_numpy(rng.integers(0, 65, n)
                                         .astype(np.int32))}
    got = TF.cluster_histogram(out, num_clusters)
    assert got.dtype == torch.int32 and got.shape == (num_clusters, 128)
    assert torch.equal(got, _hist_replaced(out, num_clusters))


@pytest.mark.parametrize("h,w,buf,presets", [
    (256, 256, (256, 256), (0,)),
    (300, 520, (512, 768), (0, 1, 0, 1, 1, 0))])
def test_cluster_histogram_equals_jax_encode_lfg_hist(h, w, buf, presets):
    """On JAX encode_lfg's own tokens, clusters and valid lengths, the
    port's histogram is its `hist`."""
    rng = np.random.default_rng(h + w)
    px = np.zeros(buf + (3,), np.uint8)
    px[:h, :w] = rng.integers(0, 256, (h, w, 3))
    num_presets = max(presets) + 1
    cmap = jax_tables.hf_cluster_map(num_presets)
    num_clusters = int(cmap.max()) + 1
    want = P.encode_lfg(jnp.asarray(px), h, w,
                        jnp.asarray(np.array(presets, np.int32)),
                        jnp.asarray(cmap), buf_h=buf[0], buf_w=buf[1],
                        linear_light=False, num_clusters=num_clusters,
                        sample_kind="uint8",
                        clusters_per_preset=num_clusters // num_presets)
    out = {k: torch.from_numpy(np.asarray(want[k]).copy())
           for k in ("tokens", "clusters", "valid_len")}
    got = TF.cluster_histogram(out, num_clusters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["hist"]))
    assert int(got.sum()) > 0
