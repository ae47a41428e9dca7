"""Whole files of the port for u16, f32 and linear-light input, ICC
tagging, and planar / strided / mixed-format input, on the CPU.

As in test_torch_e2e, files are compared with the port's front replaced
by the JAX package's integers (one float flip changes a file);
tolerance: equal bytes, against encode_image(..., backend="jax") or the
JAX Encoder given the same calls."""

import numpy as np
import pytest

import hydrium_tpu_torch
from hydrium_tpu import encode_image as jax_encode_image
from hydrium_tpu.config import ImageMetadata as JaxMetadata
from hydrium_tpu.config import SampleFormat as JaxFormat
from hydrium_tpu.encoder import Encoder as JaxEncoder
from hydrium_tpu_torch import (Encoder, EncodeStats, ImageMetadata,
                               SampleFormat)
from test_e2e import make_image
from test_torch_e2e import jax_front, warm_state  # noqa: F401 (fixtures)


def _as(img8, kind):
    """The u8 image as u16 (with low bits of its own), f32 sRGB, or f32
    linear light."""
    if kind == "uint16":
        low = np.random.default_rng(7).integers(0, 257, img8.shape)
        return np.minimum(img8.astype(np.uint32) * 257 + low - 128,
                          65535).clip(0).astype(np.uint16), False
    f = (img8 / 255.0).astype(np.float32)
    if kind == "float32":
        return f, False
    if kind == "float32_linear":
        return (f ** 2.2).astype(np.float32), True
    assert kind == "uint8_linear"
    return img8, True


# (100, 70): one group; (300, 2100): two LF groups one-frame; tiled, a
# stacked chunk of eight tiles and ten edge tiles
@pytest.mark.parametrize("shift", [-1, 0])
@pytest.mark.parametrize("h,w", [(100, 70), (300, 2100)])
@pytest.mark.parametrize("kind", ["uint16", "float32", "float32_linear",
                                  "uint8_linear"])
def test_bytes_equal_jax_backend(jax_front, kind, h, w, shift):
    content = "smooth" if w > 2048 else "noise"
    img, linear = _as(make_image(h, w, content, seed=h + w), kind)
    want = jax_encode_image(img, shift, linear_light=linear, backend="jax")
    stats = EncodeStats()
    got = hydrium_tpu_torch.encode_image(img, shift, linear_light=linear,
                                         device="cpu", stats=stats)
    assert got == want
    assert stats.counters.get("lfg_fallback", 0) == 0


def _minimal_icc():
    """A tiny (structurally plausible) ICC profile."""
    icc = bytearray(144)
    icc[0:4] = (144).to_bytes(4, "big")
    icc[8] = 4
    icc[12:24] = b"mntrRGB XYZ "
    icc[36:40] = b"acsp"
    icc[40:44] = b"APPL"
    icc[80:84] = icc[4:8]
    return bytes(icc)


@pytest.mark.parametrize("h,w", [(64, 64), (120, 2100)])
def test_icc_profile_gives_the_jax_encoders_bytes(jax_front, h, w):
    img = make_image(h, w, "smooth", seed=3)
    icc = _minimal_icc()
    ref = JaxEncoder(JaxMetadata(width=w, height=h), backend="jax")
    ref.set_suggested_icc_profile(icc)
    enc = Encoder(ImageMetadata(width=w, height=h), device="cpu")
    enc.set_suggested_icc_profile(icc)
    for tx in range((w + 2047) // 2048):
        ref.send_tile(img[:, tx * 2048:(tx + 1) * 2048], tx, 0)
        enc.send_tile(img[:, tx * 2048:(tx + 1) * 2048], tx, 0)
    got = enc.take_output()
    assert got == ref.take_output()
    untagged = hydrium_tpu_torch.encode_image(img, device="cpu")
    assert got != untagged and len(got) > len(untagged)
    # None takes the profile away again
    enc2 = Encoder(ImageMetadata(width=w, height=h), device="cpu")
    enc2.set_suggested_icc_profile(icc)
    enc2.set_suggested_icc_profile(None)
    for tx in range((w + 2047) // 2048):
        enc2.send_tile(img[:, tx * 2048:(tx + 1) * 2048], tx, 0)
    assert enc2.take_output() == untagged


def test_icc_profile_raises_in_tiled_mode_and_after_the_first_tile():
    icc = _minimal_icc()
    tiled = Encoder(ImageMetadata(width=64, height=64, tile_size_shift_x=0,
                                  tile_size_shift_y=0), device="cpu")
    with pytest.raises(ValueError, match="one-frame"):
        tiled.set_suggested_icc_profile(icc)
    enc = Encoder(ImageMetadata(width=64, height=64), device="cpu")
    enc.send_tile(np.zeros((64, 64, 3), np.uint8), 0, 0)
    with pytest.raises(RuntimeError, match="before the first tile"):
        enc.set_suggested_icc_profile(icc)


def _one_tile(pixels, h=100, w=120, fmt=SampleFormat.UINT8):
    enc = Encoder(ImageMetadata(width=w, height=h), device="cpu")
    enc.send_tile(pixels, 0, 0, sample_fmt=fmt)
    return enc.take_output()


def test_planar_input_matches_packed():
    img = np.random.default_rng(6).integers(0, 255, (100, 120, 3),
                                            dtype=np.uint8)
    assert _one_tile((img[..., 0], img[..., 1], img[..., 2])) == \
        _one_tile(img)


def test_strided_view_input_matches_contiguous():
    big = np.random.default_rng(16).integers(0, 255, (240, 300, 7),
                                             dtype=np.uint8)
    view = big[10:110, 40:160, 2:5]          # strided in all three axes
    assert not view.flags.c_contiguous
    assert _one_tile(view) == _one_tile(np.ascontiguousarray(view))


def test_mixed_sample_formats_across_tiles(jax_front):
    """The sample format may change from tile to tile: the port gives
    the JAX encoder's bytes for the same calls, all-u8 and mixed (the
    second LF group as u16 = u8 * 257).  The two files differ from each
    other in both packages: the front scales u8 and u16 samples by
    float32 reciprocals, which do not round alike."""
    img = np.random.default_rng(17).integers(0, 255, (100, 4000, 3),
                                             dtype=np.uint8)    # 2 LFGs
    outs = []
    for make, F in ((lambda: JaxEncoder(JaxMetadata(width=4000, height=100),
                                        backend="jax"), JaxFormat),
                    (lambda: Encoder(ImageMetadata(width=4000, height=100),
                                     device="cpu"), SampleFormat)):
        a, b = make(), make()
        for enc, second in ((a, (img[:, 2048:], F.UINT8)),
                            (b, (img[:, 2048:].astype(np.uint16) * 257,
                                 F.UINT16))):
            enc.send_tile(img[:, :2048], 0, 0, sample_fmt=F.UINT8)
            enc.send_tile(second[0], 1, 0, sample_fmt=second[1])
        outs.append((a.take_output(), b.take_output()))
    (jax_u8, jax_mixed), (mine_u8, mine_mixed) = outs
    assert mine_u8 == jax_u8
    assert mine_mixed == jax_mixed
    assert len(mine_u8) > 100000 and len(mine_mixed) > 100000
