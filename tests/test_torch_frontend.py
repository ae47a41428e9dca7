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

from hydrium_tpu.ops import pipeline as P
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
    q1, lf1 = TFE.frontend_lfg(torch.from_numpy(px), h, w, **kw)
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


def _jax_tokens(q, presets, h, w, bh, bw, per):
    """JAX pipeline.tokenize_flat on q plus encode_lfg's extent mask
    (pipeline.py:376-386)."""
    gcy, gcx = bh >> 8, bw >> 8
    G = gcy * gcx
    q = jnp.asarray(q)
    nz = jnp.sum((q != 0).astype(jnp.int32), axis=-1)
    out = list(P.tokenize_flat(q, nz, jnp.repeat(jnp.asarray(presets), 3072),
                               jnp.tile(jnp.arange(3, dtype=jnp.int32),
                                        G * 1024), per))
    vh, vw = (h + 7) >> 3, (w + 7) >> 3
    gbh = jnp.clip(vh - jnp.arange(gcy) * 32, 0, 32)
    gbw = jnp.clip(vw - jnp.arange(gcx) * 32, 0, 32)
    b = jnp.arange(32)
    ok = ((b[None, :, None, None] < gbh[:, None, None, None])
          & (b[None, None, None, :] < gbw[None, None, :, None]))
    ok = ok.transpose(0, 2, 1, 3).reshape(-1)
    out[4] = jnp.where(jnp.repeat(ok, 3), out[4], 0)
    return [np.asarray(a) for a in out]


def _huge_f32(shape, seed):
    """f32 linear samples, a fifth of them +-1e30 or +-1e25, so q
    saturates and hybridize sees values >= 2^31."""
    rng = np.random.default_rng(seed)
    px = rng.random(shape).astype(np.float32)
    big = rng.random(shape) < 0.2
    px[big] = rng.choice(np.float32([1e30, -1e30, 1e25, -1e25]),
                         int(big.sum()))
    return px


TOKENS_CASES = [
    # per, kind, linear, h, w, buf, upload
    (9, "uint8", False, 300, 520, (512, 768), (320, 544)),   # partial
    (3, "uint16", False, 300, 520, (512, 768), (512, 768)),
    (2, "float32", True, 112, 200, (256, 256), (128, 224)),  # edge tile
    (1, "uint8", False, 112, 200, (256, 256), (128, 224)),
    (9, "float32", True, 256, 512, (256, 512), (256, 512)),
    (9, "huge", True, 200, 300, (256, 512), (224, 320)),
]


@pytest.mark.parametrize("per,kind,linear,h,w,buf,upload", TOKENS_CASES)
def test_tokens_plain_matches_jax_tokenize(per, kind, linear, h, w, buf,
                                           upload):
    """frontend_tokens_plain equals JAX tokenize_flat + the extent mask
    fed the same q, exactly, with presets that differ per group."""
    bh, bw = buf
    uh, uw = upload
    if kind == "huge":
        px, kind = _huge_f32((uh, uw, 3), h), "float32"
    else:
        px = np.full((uh, uw, 3), 255 if kind == "uint8" else 1.0,
                     _pixels(kind, (1, 1, 3), 0).dtype)
        px[:h, :w] = _pixels(kind, (h, w, 3), h + w + per)
    G = (bh >> 8) * (bw >> 8)
    presets = (np.arange(G, dtype=np.int32) * 7 + per) % 40
    kw = dict(buf_h=bh, buf_w=bw, linear_light=linear, sample_kind=kind)
    q, lf = TFE.frontend_lfg_plain(torch.from_numpy(px), h, w, **kw)
    got = TFE.frontend_tokens_plain(torch.from_numpy(px), h, w,
                                    torch.from_numpy(presets),
                                    clusters_per_preset=per, **kw)
    assert torch.equal(got["lf_q"], lf)
    want = _jax_tokens(q.numpy(), presets, h, w, bh, bw, per)
    names = ("tokens", "clusters", "residues", "residue_bits", "valid_len")
    views = (np.uint16, np.uint8, np.uint32, np.uint8, np.int32)
    for n, v, wa in zip(names, views, want):
        np.testing.assert_array_equal(got[n].numpy().view(v), wa, err_msg=n)
    if h == 200 and w == 300:
        assert (q == torch.iinfo(torch.int32).max).any()
        assert (got["residue_bits"] == 0).any() and (
            got["tokens"].numpy().view(np.uint16) >= 1 << 15).any()


def test_tokens_wrapper_takes_plain_twin_on_cpu():
    px = torch.from_numpy(_pixels("uint8", (256, 512, 3), 8))
    presets = torch.tensor([1, 2], dtype=torch.int32)
    kw = dict(buf_h=256, buf_w=512, linear_light=False, sample_kind="uint8",
              clusters_per_preset=9)
    before = (TFE.frontend_tokens.launches, TFE.frontend_groups.launches)
    got = TFE.frontend_tokens(px, 250, 500, presets, **kw)
    want = TFE.frontend_tokens_plain(px, 250, 500, presets, **kw)
    assert (TFE.frontend_tokens.launches,
            TFE.frontend_groups.launches) == before
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_tokens_wrapper_rejects_other_devices():
    px = torch.zeros((256, 256, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        TFE.frontend_tokens(px, 256, 256, torch.zeros(1, dtype=torch.int32),
                            buf_h=256, buf_w=256, linear_light=False,
                            sample_kind="uint8", clusters_per_preset=9)


def test_kernel_tables():
    """The kernel's integer table: the inverse of the zig-zag order, then
    the cluster rule's context tables as the FrontEnd holds them."""
    tab = TFE._tables(torch.device("cpu"))
    it = tab.itab.numpy()
    assert it.dtype == np.int32 and it.shape == (191,)
    np.testing.assert_array_equal(it[C.ZZ_POS], np.arange(64))
    fe = TF.FrontEnd.from_tables()
    np.testing.assert_array_equal(it[64:128], fe.cnzc3.numpy())
    np.testing.assert_array_equal(it[128:], fe.cfc3.numpy())
    assert torch.equal(tab.cnzc3, fe.cnzc3) and torch.equal(tab.cfc3,
                                                            fe.cfc3)
