"""Streaming one-frame mode of the port on the CPU: twins of
tests/test_streaming.py.  Per-preset eager ANS with a fixed
log_alphabet_size decodes to the same pixels as the at-finalize scheme;
spooled sections stream out as the in-RAM ones; spool directories go."""

import os

import numpy as np

from hydrium_tpu.utils import djxl
from hydrium_tpu_torch import Encoder, ImageMetadata
from hydrium_tpu_torch.jxl.frame import (HF_GROUPS_KEY, FrameSections,
                                         StreamingHFStream)
from test_streaming import make_image
from test_torch_e2e import warm_state  # noqa: F401 (autouse fixture)


def _send_all(enc, img):
    h, w = img.shape[:2]
    for ty in range((h + 2047) // 2048):
        for tx in range((w + 2047) // 2048):
            enc.send_tile(img[ty * 2048:(ty + 1) * 2048,
                              tx * 2048:(tx + 1) * 2048], tx, ty)


def _encode(img, **kw):
    h, w = img.shape[:2]
    enc = Encoder(ImageMetadata(width=w, height=h), device="cpu", **kw)
    _send_all(enc, img)
    return enc.take_output()


def test_streaming_decodes_like_regular(tmp_path):
    img = make_image(300, 2500, seed=8)  # 1x2 LF groups
    regular = _encode(img, streaming=False)
    streamed = _encode(img, streaming=True)
    spooled = _encode(img, streaming=True, spool_dir=str(tmp_path))
    assert _encode(img) == streamed     # multi-group frames stream
    assert spooled == streamed
    assert np.array_equal(djxl.decode(streamed), djxl.decode(regular))
    # size within a few bytes (same freqs, different alias layout)
    assert abs(len(streamed) - len(regular)) < 0.01 * len(regular) + 64


def test_single_group_frame_never_streams():
    img = make_image(200, 256, seed=3)
    enc = Encoder(ImageMetadata(width=256, height=200), device="cpu",
                  streaming=True)
    assert not enc.streaming
    _send_all(enc, img)
    assert enc.take_output() == _encode(img, streaming=False)


def test_streaming_sections_follow_arrival_order():
    """With several LF groups per preset and out-of-order arrival,
    presets flush out of arrival order; sections still come out in
    global LF group arrival order (the TOC permutation's assumption)."""
    hf = StreamingHFStream(2, [2, 2], FrameSections(True))
    tokens = np.zeros((4, 3, 64), np.uint16)
    clusters = np.zeros((4, 3, 64), np.uint8)
    residues = np.zeros((4, 3, 64), np.uint32)
    rbits = np.zeros((4, 3, 64), np.uint8)
    valid = np.ones((4, 3), np.int32)
    for preset, marker in ((1, 5), (1, 6), (0, 7), (0, 8)):
        t = tokens.copy()
        t[0, 0, 0] = marker     # distinguishes sections by content
        hf.add_group_padded(t, clusters, residues, rbits, valid, preset)
        hf.finish_lfg(preset)   # preset 1 flushes first
    hf.encode_group_sections()
    keys = [k for k, _ in hf.sections.items()]
    assert keys == [HF_GROUPS_KEY + (arrival, 0) for arrival in range(4)]


def test_spooled_streaming_bytes_equal_and_iter_output(tmp_path):
    """Spooling LF and HF sections to disk and draining by iter_output
    gives exactly the in-RAM streaming bytes, in bounded chunks."""
    img = np.random.default_rng(21).integers(0, 256, (300, 4100, 3),
                                             dtype=np.uint8)    # 3 LFGs
    ram = _encode(img, streaming=True)
    enc = Encoder(ImageMetadata(width=4100, height=300), device="cpu",
                  streaming=True, spool_dir=str(tmp_path))
    _send_all(enc, img)
    chunks = list(enc.iter_output(chunk_size=1 << 16))
    assert b"".join(chunks) == ram
    assert len(chunks) > 4 and max(map(len, chunks)) < (1 << 16) + (1 << 22)
    assert enc.stats.bytes_out == len(ram)
    assert list(enc.iter_output()) == []


def test_spool_dirs_removed_on_drain_and_close(tmp_path):
    img = make_image(300, 2500, seed=9)  # 1x2 LF groups
    spool_dirs = lambda: [d for d in os.listdir(tmp_path)
                          if d.startswith("hydspool-")]
    # drained encode: dirs exist mid-encode, gone after the last chunk
    enc = Encoder(ImageMetadata(width=2500, height=300), device="cpu",
                  spool_dir=str(tmp_path))
    _send_all(enc, img)
    assert spool_dirs(), "expected live spool dirs mid-encode"
    assert enc.take_output()[:2] == b"\xff\x0a"
    assert not spool_dirs(), "drain must remove the spool dirs"
    # abandoned encode: close() cleans up without draining
    enc2 = Encoder(ImageMetadata(width=2500, height=300), device="cpu",
                   spool_dir=str(tmp_path))
    _send_all(enc2, img)
    assert spool_dirs()
    enc2.close()
    assert not spool_dirs(), "close() must remove the spool dirs"
