"""The port's fused front (hydrium_tpu_torch/ops/frontend.py) on the CPU:
its plain twin against the JAX package's Pallas frontend_groups in
interpret mode, and the fused against the unfused FrontEnd.

The plain twin and the Pallas kernel differ in the cube root (signed
pow against exp(log/3)) and in summation order, so the bar is
test_pallas_frontend's own: |dc diff| <= 1 with diff 1 on < 2% of the
values, and q equal on > 99.9%.  Measured here: dc equal everywhere, q
unequal on 1 of 393,216 (u8, two groups), 1 of 196,608 (u16) and 3 of
196,608 (f32 linear light) values, each off by 1.  At partial extents
(the encode path's pad and mask): q unequal on 1 of 1,179,648 (u8,
300x520 in 512x768) and 0 of 393,216 (f32), dc off by 1 on 0 and 1
values.  Without the mask the twin misses dc by more than 1 on 315 and
195 values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydrium_tpu.ops.pallas import frontend as PF
from hydrium_tpu_torch.ops import constants as C
from hydrium_tpu_torch.ops import front as TF
from hydrium_tpu_torch.ops import frontend as TFE

# fused vs unfused front: the mask in the pixel domain and the
# premultiplied weight move a few truncations
FLIP_TOL = 1e-4


def _pixels(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "uint16":
        return rng.integers(0, 65536, shape, dtype=np.uint16)
    return (rng.random(shape) ** 2.2).astype(np.float32)


@pytest.mark.parametrize("kind,linear,groups,seed", [
    ("uint8", False, 2, 0),        # test_pallas_frontend's input
    ("uint16", False, 1, 1),
    ("float32", True, 1, 2),
])
def test_plain_twin_matches_pallas_interpret(kind, linear, groups, seed):
    px = _pixels(kind, (groups, 256, 256, 3), seed)
    q, dc = PF.frontend_groups(jnp.asarray(px), linear_light=linear,
                               sample_kind=kind, interpret=True)
    q, dc = np.array(q), np.array(dc)
    tq, tdc = TFE.frontend_groups_plain(torch.from_numpy(px),
                                        linear_light=linear,
                                        sample_kind=kind)
    assert tq.shape == q.shape and tdc.shape == dc.shape
    assert tq.dtype == torch.int32 and tdc.dtype == torch.int32
    d = np.abs(dc.astype(np.int64) - tdc.numpy())
    assert np.mean(d > 1) == 0 and np.mean(d == 1) < 0.02
    assert np.mean(q == tq.numpy()) > 0.999


@pytest.mark.parametrize("kind,linear,h,w,buf,upload", [
    ("uint8", False, 300, 520, (512, 768), (320, 544)),
    ("float32", True, 200, 300, (256, 512), (224, 320)),
])
def test_plain_twin_matches_pallas_front_at_partial_extent(
        kind, linear, h, w, buf, upload):
    """encode_lfg's use_pallas branch (ops/pipeline.py): pad the upload to
    the buffer, zero pixels outside the true extent, run frontend_groups
    per 256^2 group and put the dc back on the varblock grid.  Against
    frontend_lfg_plain on the same upload, whose samples outside the true
    extent are nonzero, under the bar above."""
    bh, bw = buf
    uh, uw = upload
    gcy, gcx = bh >> 8, bw >> 8
    px = np.full((uh, uw, 3), 255 if kind == "uint8" else 1.0,
                 _pixels(kind, (1, 1, 3), 0).dtype)
    px[:h, :w] = _pixels(kind, (h, w, 3), h + w)
    jp = jnp.pad(jnp.asarray(px), ((0, bh - uh), (0, bw - uw), (0, 0)))
    keep = ((jnp.arange(bh)[:, None, None] < h)
            & (jnp.arange(bw)[None, :, None] < w))
    groups = jnp.where(keep, jp, 0).reshape(gcy, 256, gcx, 256, 3).transpose(
        0, 2, 1, 3, 4).reshape(gcy * gcx, 256, 256, 3)
    q, dc = PF.frontend_groups(groups, linear_light=linear, sample_kind=kind,
                               interpret=True)
    q = np.array(q).reshape(-1, 64)
    lf = np.array(dc).reshape(gcy, gcx, 32, 32, 3).transpose(
        0, 2, 1, 3, 4).reshape(bh >> 3, bw >> 3, 3)
    tq, tlf = TFE.frontend_lfg_plain(torch.from_numpy(px), h, w, buf_h=bh,
                                     buf_w=bw, linear_light=linear,
                                     sample_kind=kind)
    assert tq.shape == q.shape and tlf.shape == lf.shape
    d = np.abs(lf.astype(np.int64) - tlf.numpy())
    assert np.mean(d > 1) == 0 and np.mean(d == 1) < 0.02
    assert np.mean(q == tq.numpy()) > 0.999


def test_wrapper_takes_plain_twin_on_cpu():
    px = torch.from_numpy(_pixels("uint8", (2, 256, 256, 3), 5))
    before = TFE.frontend_groups.launches
    got = TFE.frontend_groups(px, linear_light=False, sample_kind="uint8")
    want = TFE.frontend_groups_plain(px, linear_light=False,
                                     sample_kind="uint8")
    assert TFE.frontend_groups.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lfg_buffer_layout_equals_groups():
    """frontend_lfg over a 2x3-group buffer gives the flat group order
    and the varblock grid of the same groups run one by one."""
    px = torch.from_numpy(_pixels("uint8", (512, 768, 3), 6))
    q, lf = TFE.frontend_lfg(px, 512, 768, buf_h=512, buf_w=768,
                             linear_light=False, sample_kind="uint8")
    groups = px.reshape(2, 256, 3, 256, 3).permute(0, 2, 1, 3, 4)
    gq, gdc = TFE.frontend_groups(groups.reshape(6, 256, 256, 3),
                                  linear_light=False, sample_kind="uint8")
    assert torch.equal(q, gq.reshape(-1, 64))
    grid = gdc.reshape(2, 3, 32, 32, 3).permute(0, 2, 1, 3, 4)
    assert torch.equal(lf, grid.reshape(64, 96, 3))


@pytest.mark.parametrize("h,w,buf,upload,kind,linear", [
    (512, 512, (512, 512), (512, 512), "uint8", False),
    (300, 520, (512, 768), (512, 768), "uint8", False),    # partial extent
    (300, 520, (512, 768), (320, 544), "uint16", False),   # short upload
    (200, 300, (256, 512), (224, 320), "float32", True),
])
def test_fused_front_close_to_unfused(h, w, buf, upload, kind, linear):
    bh, bw = buf
    uh, uw = upload
    px = np.zeros((uh, uw, 3), _pixels(kind, (1, 1, 3), 0).dtype)
    px[:h, :w] = _pixels(kind, (h, w, 3), h + w)
    fe = TF.FrontEnd.from_tables()
    kw = dict(buf_h=bh, buf_w=bw, linear_light=linear, sample_kind=kind)
    q0, lf0 = fe(torch.from_numpy(px), h, w, **kw)
    q1, lf1 = fe(torch.from_numpy(px), h, w, fused=True, **kw)
    assert q1.shape == q0.shape and lf1.shape == lf0.shape
    flips = int((q0 != q1).sum()) + int((lf0 != lf1).sum())
    assert flips <= FLIP_TOL * (q0.numel() + lf0.numel()), flips
    assert int((q0 - q1).abs().max()) <= 2
    assert int((lf0 - lf1).abs().max()) <= 1


def test_front_tables_equal_pallas_constants():
    np.testing.assert_array_equal(C.HF_W_SCALED, PF._HF_W_SCALED)
    np.testing.assert_array_equal(C.DCT_BASIS, PF._DCT_BASIS)
    np.testing.assert_array_equal(
        C.ZZ_POS, PF.tables.ZIGZAG_KY * 8 + PF.tables.ZIGZAG_KX)


def test_default_fused_reads_hydrium_pallas(monkeypatch):
    monkeypatch.delenv("HYDRIUM_PALLAS", raising=False)
    assert TFE.default_fused() is False
    monkeypatch.setenv("HYDRIUM_PALLAS", "1")
    assert TFE.default_fused() is True
    monkeypatch.setenv("HYDRIUM_PALLAS", "0")
    assert TFE.default_fused() is False


def test_wrapper_rejects_other_devices():
    px = torch.zeros((256, 256, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        TFE.frontend_lfg(px, 256, 256, buf_h=256, buf_w=256,
                         linear_light=False, sample_kind="uint8")
