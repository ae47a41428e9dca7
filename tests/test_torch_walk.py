"""The packed walk (csrc/host/serializer.cc hyd_hf_add_lfg_packed,
through jxl/native.py NativeHF) on the payloads of a real CPU encode:
every thread count gives the same symbols, a wrong symbol count raises
and leaves the stream as it was, and the encoder counts the symbols it
walked (counter walk_symbols, which jxlbench's walk_ns_per_sym reads)."""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest

import hydrium_tpu_torch
from hydrium_tpu_torch import EncodeStats, ImageMetadata, host
from hydrium_tpu_torch import encoder as TE
from hydrium_tpu_torch.jxl import native
from hydrium_tpu_torch.jxl.tokcode import TokenCodec
from test_e2e import make_image
from test_torch_e2e import prep_pool_idle, warm_state  # noqa: F401
from test_torch_tiled import _tiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image():
    """300x2100: two LF groups (2048 and 52 columns) of 2x8 and 2x1
    buffer groups, with photo-like noise over smooth content."""
    img = make_image(300, 2100, "smooth")
    noise = np.random.default_rng(1).normal(0, 4, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """(payloads, walk_symbols, symbols walked) of one one-frame encode
    on the CPU: each LF group's parsed payload as the drain worker walks
    it, the encoder's walk_symbols counter, and the sum of the symbol
    counts of every successful NativeHF.add_lfg_packed call.  The
    process-wide codec state is patched as warm_state patches it."""
    img = _image()
    payloads, walked = [], []
    feed, walk = host._feed_hf_packed, native.NativeHF.add_lfg_packed

    def keep(hf, parsed, lfg, buf_w, buf_h, preset, tok_lut):
        payloads.append({
            "args": (parsed["tok_words"].copy(), parsed["res_words"].copy(),
                     tok_lut.copy(), hf.cluster_map, preset,
                     (buf_h >> 8, buf_w >> 8),
                     (lfg.varblock_height, lfg.varblock_width),
                     parsed["tok_off"], parsed["res_off"]),
            "gs": parsed["gs"].copy()})
        return feed(hf, parsed, lfg, buf_w, buf_h, preset, tok_lut)

    def counted(self, *args, **kw):
        walk(self, *args, **kw)
        walked.append(int(np.sum(args[9])))

    codec = TokenCodec()
    codec.update(np.full((10, 64), 50))
    with pytest.MonkeyPatch.context() as mp:
        warm = tmp_path_factory.mktemp("warm") / "warm.npz"
        mp.setattr(TE, "_WARM_CACHE", str(warm))
        mp.setattr(TE, "_SHARED_CODEC", codec)
        mp.setattr(TE, "_WIDE_HINT", {})
        mp.setattr(host, "_feed_hf_packed", keep)
        mp.setattr(native.NativeHF, "add_lfg_packed", counted)
        stats = EncodeStats()
        hydrium_tpu_torch.encode_image(img, device="cpu", stats=stats)
        prep_pool_idle()
    assert stats.counters.get("lfg_fallback", 0) == 0
    assert len(payloads) == 2 and len(payloads[0]["gs"]) == 16
    return payloads, stats.counters["walk_symbols"], sum(walked)


def _walk(payloads, n_threads, hf=None, gs=None):
    """Walk every payload into one NativeHF (fresh unless given); gs
    replaces the symbol counts of the last payload."""
    if hf is None:
        hf = native.NativeHF(int(payloads[0]["args"][3].max()) + 1)
    for i, p in enumerate(payloads):
        counts = gs if gs is not None and i == len(payloads) - 1 \
            else p["gs"]
        hf.add_lfg_packed(*p["args"], counts, n_threads=n_threads)
    return hf


def _result(hf, n_clusters):
    """las, every cluster's frequencies and every ANS section's bytes."""
    hf.prepare()
    return (hf.las, [hf.frequencies(c).tolist() for c in range(n_clusters)],
            [w.export_raw() for w in hf.encode_all(2)])


@pytest.mark.parametrize("n_threads", [3, 8])
def test_thread_counts_walk_alike(encoded, n_threads):
    payloads = encoded[0]
    n = int(payloads[0]["args"][3].max()) + 1
    want = _result(_walk(payloads, 1), n)
    assert len(want[2]) == 18
    assert _result(_walk(payloads, n_threads), n) == want


@pytest.mark.parametrize("group,delta", [(0, 1), (1, -1)])
def test_wrong_count_raises_and_rolls_back(encoded, group, delta):
    """A symbol count one off in one group of the second LF group (the
    first walked already) fails the call; the same stream then walks the
    right counts to what a fresh walk gives."""
    payloads = encoded[0]
    n = int(payloads[0]["args"][3].max()) + 1
    hf = native.NativeHF(n)
    bad = payloads[-1]["gs"].copy()
    bad[group] += delta
    with pytest.raises(RuntimeError, match="packed walk failed"):
        _walk(payloads, 8, hf, bad)
    hf.add_lfg_packed(*payloads[-1]["args"], payloads[-1]["gs"],
                      n_threads=8)
    assert _result(hf, n) == _result(_walk(payloads, 8), n)


def test_one_frame_counts_the_symbols_it_walks(encoded):
    payloads, counted, walked = encoded
    assert counted == walked == sum(int(p["gs"].sum()) for p in payloads)


def test_tiled_renders_count_the_symbols_they_walk(monkeypatch):
    walked = []
    walk = native.NativeHF.add_lfg_packed

    def counted(self, *args, **kw):
        walk(self, *args, **kw)
        walked.append(int(np.sum(args[9])))

    monkeypatch.setattr(native.NativeHF, "add_lfg_packed", counted)
    img = make_image(300, 700, "noise", seed=15)
    enc = hydrium_tpu_torch.Encoder(
        ImageMetadata(width=700, height=300, tile_size_shift_x=0,
                      tile_size_shift_y=0), device="cpu")
    enc.send_tile_batch(_tiles(img, 256, 256))
    assert enc.take_output()
    assert len(walked) == 6
    assert enc.stats.counters["walk_symbols"] == sum(walked) > 0


def _reader():
    path = os.path.join(ROOT, "jxlbench", "metrics", "walk_ns_per_sym.py")
    spec = importlib.util.spec_from_file_location("walk_ns_per_sym", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _window(*images):
    return SimpleNamespace(window=SimpleNamespace(images=[
        SimpleNamespace(stages=s, counters=c) for s, c in images]))


@pytest.mark.parametrize("images,value", [
    ([], None),
    ([({"walk": 0.1}, {"lfg_packed": 4})], None),      # no counter
    ([({"walk": 0.030}, {"walk_symbols": 6_000_000}),
      ({"walk": 0.050}, {"walk_symbols": 10_000_000})], 5.0)])
def test_walk_ns_per_sym_reader(images, value):
    got = _reader()(_window(*images))
    assert got == (None if value is None else pytest.approx(value))
