"""The port's front (hydrium_tpu_torch/ops/front.py) against the JAX
package's encode_lfg and its parts, on the CPU.

Integer stages (tokenize_flat, hybridize, lf_residuals, the histogram)
must be exactly equal on the same numpy-made inputs.  The float part
(XYB, DCT, quantization) is held to a flip bound: torch has no cbrt
(pow(x, 1/3) is one ulp off XLA's cbrt on ~1% of values) and the DCT
product sums in another order, so a few coefficients per million
truncate to the neighbouring integer.  Tolerance: at most 1e-4 of the
quantized values (HF coefficients plus LF values) differ, each by 1 or
across the HF dead zone (0 <-> +-2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydrium_tpu.ops import pipeline as P
from hydrium_tpu.ops import tables
from hydrium_tpu_torch.ops import constants as C
from hydrium_tpu_torch.ops import front as TF

FLIP_TOL = 1e-4


def _np(t):
    return t.cpu().numpy()


def test_constants_equal_pipeline():
    for name, want in [("EMIT_TO_STORE", P._EMIT_TO_STORE),
                       ("ZZ_GATHER", P._ZZ_GATHER),
                       ("HF_W_EMIT", P._HF_W_EMIT),
                       ("DCT_BASIS", P._DCT_BASIS)]:
        got = getattr(C, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ["TOK_CHUNK", "TOK_OW", "TOK_MAX_LEN", "RES_CHUNK",
                 "RES_OW_FAST", "RES_OW_WIDE", "RES_CAP_FAST",
                 "RES_LANES_FAST", "RES_CAP_WIDE", "RES_LANES_WIDE",
                 "HIST_SAMPLE_STRIDE", "AUX_SCALARS", "AUX_HIST_ROWS"]:
        assert getattr(C, name) == getattr(P, name), name
    for bh, bw in [(256, 256), (512, 768), (2048, 2048)]:
        assert C.packed_aux_len(bh, bw) == P.packed_aux_len(bh, bw)


def _flat_inputs(rng, G=2, preset_hi=3):
    """numpy-made integer front state: q [N, 64] (slot 0 zero) with a
    mix of zeros, small and large values, plus nz/preset/blockctx."""
    N = G * 3072
    q = rng.integers(-40, 41, (N, 64)).astype(np.int32)
    q[rng.random((N, 64)) < 0.6] = 0
    q[rng.random((N, 64)) < 0.01] = rng.integers(-(1 << 20), 1 << 20)
    q[:5] = 0                                  # empty block-channels
    q[5, 63] = 7                               # last slot only
    q[:, 0] = 0
    nz = (q != 0).sum(axis=1).astype(np.int32)
    presets = rng.integers(0, preset_hi, G).astype(np.int32)
    preset_flat = np.repeat(presets, 3072)
    blockctx = np.tile(np.arange(3, dtype=np.int32), G * 1024)
    return q, nz, preset_flat, blockctx


@pytest.mark.parametrize("per", [9, 3, 2, 1])
def test_tokenize_flat_exact(per):
    rng = np.random.default_rng(100 + per)
    q, nz, preset_flat, blockctx = _flat_inputs(rng)
    want = P.tokenize_flat(jnp.asarray(q), jnp.asarray(nz),
                           jnp.asarray(preset_flat), jnp.asarray(blockctx),
                           per)
    fe = TF.FrontEnd.from_tables()
    got = TF.tokenize_flat(torch.as_tensor(q), torch.as_tensor(nz),
                           torch.as_tensor(preset_flat),
                           torch.as_tensor(blockctx), per, fe)
    names = ("tokens", "clusters", "residues", "residue_bits", "valid_len")
    views = (np.uint16, np.uint8, np.uint32, np.uint8, np.int32)
    for g, w, n, v in zip(got, want, names, views):
        np.testing.assert_array_equal(_np(g).view(v), np.asarray(w),
                                      err_msg=n)


def test_hybridize_exact():
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        np.arange(0, 4096, dtype=np.int64),
        rng.integers(0, 1 << 32, 20000, dtype=np.int64),
        np.array([(1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.int64)])
    want = P.hybridize(jnp.asarray(vals.astype(np.uint32)))
    got = TF.hybridize(torch.as_tensor(vals))
    for g, w, n in zip(got, want, ("token", "residue", "residue_bits")):
        np.testing.assert_array_equal(_np(g), np.asarray(w).astype(np.int64),
                                      err_msg=n)


@pytest.mark.parametrize("seg_vb", [0, 4])
@pytest.mark.parametrize("shape", [(32, 32), (7, 1), (1, 9), (40, 24)])
def test_lf_residuals_exact(seg_vb, shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1] + seg_vb)
    lf_q = rng.integers(-3000, 3000, shape + (3,)).astype(np.int32)
    want = np.asarray(P.lf_residuals(jnp.asarray(lf_q), seg_vb))
    got = TF.lf_residuals(torch.as_tensor(lf_q), seg_vb)
    np.testing.assert_array_equal(_np(got), want.astype(np.int64))


def _decode_q(tokens, residues):
    """Quantized HF values [N, 64] back from encode_lfg's hybrid-uint
    tokens and residues (slot 0, the nonzero count, is left 0)."""
    t = tokens.astype(np.int64)
    r = residues.astype(np.int64)
    n = ((t - 16) >> 1) + 3
    big = (1 << (n + 1)) | (((t - 16) & 1) << n) | r
    v = np.where(t < 16, t, big)
    q = np.where(v & 1, -((v + 1) >> 1), v >> 1)
    q[:, 0] = 0
    return q


def _image(h, w, kind, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([0.5 + 0.4 * np.sin(xx / 37.0) * np.cos(yy / 23.0),
                     0.5 + 0.4 * np.cos(xx / 11.0 + 1) * np.sin(yy / 41.0),
                     0.5 + 0.4 * np.sin((xx + yy) / 31.0)], axis=-1)
    img = np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1)
    if kind == "uint8":
        return np.round(img * 255).astype(np.uint8)
    if kind == "uint16":
        return np.round(img * 65535).astype(np.uint16)
    return img.astype(np.float32)


FRONT_CASES = [
    (256, 256, "uint8", False),
    (100, 70, "uint8", False),
    (300, 520, "uint8", True),
    (100, 70, "uint16", False),
    (300, 520, "uint16", True),
    (256, 256, "float32", False),
    (100, 70, "float32", True),
    (300, 520, "float32", False),
]


@pytest.mark.parametrize("h,w,kind,linear", FRONT_CASES)
def test_front_vs_jax_encode_lfg(h, w, kind, linear):
    px = _image(h, w, kind, seed=h + w)
    buf_h, buf_w = ((h + 255) >> 8) << 8, ((w + 255) >> 8) << 8
    G = (buf_h >> 8) * (buf_w >> 8)
    presets = np.zeros(G, np.int32)

    want = P.encode_lfg(jnp.asarray(px), h, w, jnp.asarray(presets),
                        jnp.asarray(tables.hf_cluster_map(1)),
                        buf_h=buf_h, buf_w=buf_w, linear_light=linear,
                        num_clusters=9, sample_kind=kind)
    q_j = _decode_q(np.asarray(want["tokens"]), np.asarray(want["residues"]))
    lf_j = np.asarray(want["lf_q"]).astype(np.int64)

    fe = TF.FrontEnd.from_tables()
    q_t, lf_t = fe(torch.as_tensor(px), h, w, buf_h=buf_h, buf_w=buf_w,
                   linear_light=linear, sample_kind=kind)
    a, b = _np(q_t).astype(np.int64), q_j
    flips = int((a != b).sum()) + int((_np(lf_t) != lf_j).sum())
    total = q_j.size + lf_j.size
    assert flips <= FLIP_TOL * total, (flips, total)
    # a flip moves a value by one, or across the dead zone (0 <-> +-2)
    d = np.abs(a - b)
    assert ((d <= 1) | ((d == 2) & ((a == 0) | (b == 0)))).all()
    assert np.abs(_np(lf_t).astype(np.int64) - lf_j).max() <= 1

    # the whole encode_lfg: every output equal wherever the quantized
    # values agree (a flip can only disturb its own block-channel row)
    got = TF.encode_lfg(fe, torch.as_tensor(px), h, w,
                        torch.as_tensor(presets), buf_h=buf_h, buf_w=buf_w,
                        linear_light=linear, num_clusters=9,
                        sample_kind=kind)
    rows_ok = (a == b).all(axis=1)
    views = {"tokens": np.uint16, "residues": np.uint32,
             "lf_res": np.uint32}
    for k in ("tokens", "clusters", "residues", "residue_bits",
              "valid_len"):
        g = _np(got[k]).view(views.get(k, _np(got[k]).dtype))
        np.testing.assert_array_equal(g[rows_ok], np.asarray(want[k])[rows_ok],
                                      err_msg=k)
    lf_ok = (_np(lf_t) == lf_j).all()
    if lf_ok:
        np.testing.assert_array_equal(_np(got["lf_res"]).view(np.uint32),
                                      np.asarray(want["lf_res"]))
        np.testing.assert_array_equal(_np(got["lf_q"]),
                                      np.asarray(want["lf_q"]))
    if rows_ok.all():
        np.testing.assert_array_equal(_np(got["hist"]),
                                      np.asarray(want["hist"]))


@pytest.mark.parametrize("per,num_presets", [(9, 2), (3, 30), (2, 100),
                                             (1, 300)])
def test_cluster_histogram_exact(per, num_presets):
    rng = np.random.default_rng(per)
    q, nz, preset_flat, blockctx = _flat_inputs(rng, G=2,
                                                preset_hi=num_presets)
    num_clusters = per * num_presets
    toks = P.tokenize_flat(jnp.asarray(q), jnp.asarray(nz),
                           jnp.asarray(preset_flat), jnp.asarray(blockctx),
                           per)
    tokens, clusters, _r, _b, valid_len = [np.asarray(a) for a in toks]
    hist = jnp.zeros((num_clusters, 128), jnp.int32)
    mask = (jnp.arange(64)[None, :] < valid_len[:, None]).astype(jnp.int32)
    want = hist.at[clusters.astype(np.int32),
                   np.minimum(tokens, 127).astype(np.int32)].add(mask)
    got = TF.cluster_histogram(
        {"tokens": torch.tensor(tokens.view(np.int16)),
         "clusters": torch.tensor(clusters),
         "valid_len": torch.tensor(valid_len)}, num_clusters)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("per,lf_seg_vb", [(9, 0), (3, 4)])
def test_front_tokens_fused_takes_tokens_twin(per, lf_seg_vb):
    """front_tokens(fused=True) on the CPU is frontend_tokens_plain plus
    the LF residuals, exactly; the unfused front goes through the same
    tokenize_lfg."""
    from hydrium_tpu_torch.ops import frontend as TFE

    px = torch.as_tensor(_image(300, 520, "uint8", seed=3))
    presets = torch.tensor([0, 2, 1, 3, 0, 1], dtype=torch.int32)
    kw = dict(buf_h=512, buf_w=768, linear_light=False, sample_kind="uint8")
    fe = TF.FrontEnd.from_tables()
    got = TF.front_tokens(fe, px, 300, 520, presets, clusters_per_preset=per,
                          lf_seg_vb=lf_seg_vb, fused=True, **kw)
    want = TFE.frontend_tokens_plain(px, 300, 520, presets,
                                     clusters_per_preset=per, **kw)
    assert list(got) == ["lf_q", "lf_res", "tokens", "clusters", "residues",
                         "residue_bits", "valid_len"]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert torch.equal(got["lf_res"],
                       TF.bits32(TF.lf_residuals(want["lf_q"], lf_seg_vb)))
    q, lf = fe(px, 300, 520, **kw)
    unfused = TF.front_tokens(fe, px, 300, 520, presets,
                              clusters_per_preset=per, lf_seg_vb=lf_seg_vb,
                              **kw)
    toks = TF.tokenize_lfg(q, presets, 300, 520, buf_h=512, buf_w=768,
                           clusters_per_preset=per, tabs=fe)
    for k, v in toks.items():
        assert torch.equal(unfused[k], v), k
    assert torch.equal(unfused["lf_q"], lf)
