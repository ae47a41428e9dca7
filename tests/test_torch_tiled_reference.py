"""The port's tiled mode (Encoder.send_tile_batch, the fused front, as
jxlbench/loop.py drives it: one call per row of tiles) on the CPU,
against the benchmark's plain reference rather than the JAX package:
every tile frame is parsed whole by jxlbench/ref/decode.py and its
coefficients held to jxlbench/ref/front.py's float64 front.  Then the
tile path's span, stage and counter (render_queue, render, tile_frames)
and their readers in jxlbench/metrics, and a 4K tiled file that must
stay byte for byte what it was."""

import hashlib
import importlib.util
import json
import os
import threading

import numpy as np
import pytest

import hydrium_tpu_torch
from hydrium_tpu_torch import ImageMetadata
from jxlbench.check import judge_file
from test_e2e import make_image
from test_torch_e2e import warm_state  # noqa: F401 (autouse fixture)
from test_torch_walk import ROOT, _window

MARGIN_MAX = 0.01       # jxlbench/configs/u8_tiled256_fused.json's limit


def _photo(h, w, seed):
    from jxlbench.content import photo

    path = os.path.join(ROOT, "jxlbench", "traffic", "photo4k.json")
    with open(path) as f:
        params = dict(json.load(f)["params"], height=h, width=w)
    return photo.make(params, seed, 1, "cpu")[0]


def _encode_rows(img, stats=None, backend=None, fused_front=True):
    """The tiled file of img, sent one row of 256x256 tiles a call."""
    h, w = img.shape[:2]
    meta = ImageMetadata(width=w, height=h, tile_size_shift_x=0,
                         tile_size_shift_y=0)
    enc = hydrium_tpu_torch.Encoder(
        meta, backend=backend, device="cpu",
        fused_front=fused_front if backend is None else None)
    if stats is not None:
        enc.stats = stats
    out = bytearray()
    for ty in range((h + 255) // 256):
        row = img[ty * 256:(ty + 1) * 256]
        enc.send_tile_batch([(row[:, tx * 256:(tx + 1) * 256], tx, ty)
                             for tx in range((w + 255) // 256)])
        out.extend(enc.take_output())
    return bytes(out), enc.stats


@pytest.mark.parametrize("h,w,seed", [
    (264, 520, 2**31 + 7),      # an edge row and an edge column of tiles
    (1072, 1280, 5),            # 20 full tiles: a stack of 16 and one of 4
], ids=["edges", "two_stacks"])
def test_tile_batch_files_pass_the_plain_reference(h, w, seed):
    img = _photo(h, w, seed)
    data, stats = _encode_rows(img)
    tiles = ((h + 255) // 256) * ((w + 255) // 256)
    assert stats.counters["tile_frames"] == tiles
    assert stats.counters.get("lfg_fallback", 0) == 0
    verdict = judge_file(img, data)
    assert "parse_fault" not in verdict, verdict
    assert verdict["margin_max"] <= MARGIN_MAX


def test_tile_frames_and_render_spans_of_each_tile():
    """264x520: 2 full tiles in one stack, 4 edge tiles.  One render per
    tile and one render_queue per tile of the stack (an edge tile renders
    on the caller, unqueued), tagged with its (y, x); tile_frames counts
    the frames, and the readers give the stages' mean per image."""
    from hydrium_tpu_torch import EncodeStats

    stats = EncodeStats()
    stats.enable_timeline()
    _encode_rows(make_image(264, 520, "noise", seed=31), stats)
    tags = {f"{ty},{tx}" for ty in range(2) for tx in range(3)}
    stacked = {"0,0", "0,1"}
    assert stats.counters["tile_frames"] == len(tags)
    caller = threading.current_thread().name
    for name, want in (("render_queue", stacked), ("render", tags)):
        got = [e for e in stats.events if e[0].startswith(name + "[")]
        assert sorted(e[0] for e in got) == sorted(f"{name}[{t}]"
                                                   for t in want)
        assert all((e[3] == caller) == (e[0][len(name) + 1:-1] not in
                                        stacked) for e in got)
    one_frame = hydrium_tpu_torch.EncodeStats()
    hydrium_tpu_torch.encode_image(make_image(64, 300, "noise", seed=32),
                                   device="cpu", stats=one_frame)
    images = [(dict(stats.stage_seconds), dict(stats.counters))] * 2
    for name in ("render_queue", "render"):
        read = _reader(f"{'tile_render' if name == 'render' else name}_ms")
        assert read(_window(*images)) == pytest.approx(
            1e3 * stats.stage_seconds[name])
        assert read(_window((dict(one_frame.stage_seconds),
                             dict(one_frame.counters)))) is None
        assert read(_window()) is None


def _reader(name):
    path = os.path.join(ROOT, "jxlbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_4k_tiled_file_is_unchanged():
    """A 3840x2160 image in 135 one-group tile frames through the
    conformance plane (fixed point, the same bytes on every host), whose
    frames take the native ANS's one-group path: the file is the one the
    encoder gave before that path stopped starting threads."""
    img = np.random.default_rng(2160).integers(0, 256, (2160, 3840, 3),
                                               dtype=np.uint8)
    data, stats = _encode_rows(img, backend="numpy")
    assert stats.counters["tile_frames"] == 135
    assert len(data) == 15030662
    assert hashlib.sha256(data).hexdigest() == \
        "9dd5470da3b023d29a1c37f7fb184c9957af04e2e736d40bdc19f9f0de87b039"
