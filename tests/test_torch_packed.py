"""The port's packed payload (hydrium_tpu_torch/ops/packed.py) against
the JAX package on the CPU.

Fed the integers of JAX encode_lfg, pack_payload must give JAX
encode_lfg_packed's combined buffer word for word (fast and wide
executables, one and several groups).  The ok=2 (a residue field wider
than RES_CAP_FAST) and ok=0 (a token outside the 64-symbol transport
alphabet) outcomes are checked stage by stage on synthetic front
integers against the JAX stages _hf_transport_streams, _hf_pack_streams
and _lf_pack_stream."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydrium_tpu.jxl.tokcode import TokenCodec
from hydrium_tpu.ops import pipeline as P
from hydrium_tpu.ops import tables
from hydrium_tpu_torch.ops import packed as TP

_VIEWS = {"tokens": np.int16, "residues": np.int32, "lf_res": np.int32}


def to_torch(out):
    """JAX front outputs -> the port's storage dtypes (same bits)."""
    return {k: torch.tensor(np.asarray(v).view(_VIEWS.get(k, np.asarray(v)
                                                           .dtype)))
            for k, v in out.items() if k != "hist"}


def _codec_tables(seed):
    """Transport tables of a codec adapted to a random histogram (so the
    codes are not the generic prior's)."""
    codec = TokenCodec()
    rng = np.random.default_rng(seed)
    codec.update((rng.pareto(1.5, (10, 64)) * 50).astype(np.int64))
    lens, codes, _ = codec.tables()
    return lens.astype(np.int32), codes.astype(np.int32)


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(xx / 19.0)[..., None] * np.cos(yy / 13.0)[
        ..., None]
    return np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("h,w", [(256, 256), (300, 520)])
def test_pack_payload_equals_encode_lfg_packed(h, w, wide):
    img = _image(h, w, seed=h * w)
    buf_h, buf_w = ((h + 255) >> 8) << 8, ((w + 255) >> 8) << 8
    G = (buf_h >> 8) * (buf_w >> 8)
    lens, codes = _codec_tables(h + w)
    kw = dict(buf_h=buf_h, buf_w=buf_w, linear_light=False, num_clusters=9,
              sample_kind="uint8")
    args = (jnp.asarray(img), h, w, jnp.zeros(G, jnp.int32),
            jnp.asarray(tables.hf_cluster_map(1)))
    want = np.asarray(P.encode_lfg_packed(
        *args, jnp.asarray(lens), jnp.asarray(codes), tok_classes=9,
        wide_residues=wide, **kw)["combined"])
    front = P.encode_lfg(*args, clusters_per_preset=9, **kw)
    got = TP.pack_payload(to_torch(front), torch.tensor(lens),
                          torch.tensor(codes), tok_classes=9,
                          wide_residues=wide)
    got = got.numpy().view(np.uint32)
    assert want[0] == 1
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _synthetic_front(q_patch):
    """One group's front integers from a numpy q (slot 0 unused),
    tokenized by the JAX package; q_patch edits q first."""
    rng = np.random.default_rng(17)
    N = 3072
    q = rng.integers(-6, 7, (N, 64)).astype(np.int32)
    q[rng.random((N, 64)) < 0.5] = 0
    q[:, 0] = 0
    q_patch(q)
    nz = (q != 0).sum(1).astype(np.int32)
    toks = P.tokenize_flat(jnp.asarray(q), jnp.asarray(nz),
                           jnp.zeros(N, jnp.int32),
                           jnp.asarray(np.tile(np.arange(3, dtype=np.int32),
                                               1024)), 9)
    lf_q = rng.integers(-200, 200, (32, 32, 3)).astype(np.int32)
    names = ("tokens", "clusters", "residues", "residue_bits", "valid_len")
    out = dict(zip(names, toks))
    out["lf_q"] = jnp.asarray(lf_q)
    out["lf_res"] = P.lf_residuals(jnp.asarray(lf_q))
    return out


def _u(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32).astype(np.int64) if x.dtype == np.int32 \
        else x.astype(np.int64)


def _big(value):
    def patch(q):
        q[10, 5] = value
    return patch


@pytest.mark.parametrize("q_value,want_ok", [
    (1 << 16, 2),      # pack_signed 2^17: a 16-bit residue > RES_CAP_FAST
    (1 << 27, 0),      # hybrid token 64: outside the transport alphabet
])
def test_ok_word_stage_by_stage(q_value, want_ok):
    out = _synthetic_front(_big(q_value))
    lens, codes = _codec_tables(5)
    tl, tc = jnp.asarray(lens), jnp.asarray(codes)
    M = 3072 * 64

    j_tr = P._hf_transport_streams(out, tl, tc, 9)
    j_pk = P._hf_pack_streams(j_tr[0], j_tr[1], j_tr[3], j_tr[4], M, False)
    j_lf = P._lf_pack_stream(out, tl, tc, False)

    tout = to_torch(out)
    from hydrium_tpu_torch.ops.bitpack import bitpack_v3
    from hydrium_tpu_torch.ops.transport import hf_transport_streams

    t_tr = hf_transport_streams(tout, torch.tensor(lens), torch.tensor(codes),
                                9)
    for g, w, n in zip(t_tr, j_tr, ("t_flat", "t_bits", "hist64", "r_flat",
                                    "r_bits", "tok_ok")):
        np.testing.assert_array_equal(_u(g), _u(w), err_msg=n)
    tok_words, tok_nw, _ = bitpack_v3(t_tr[0], t_tr[1], P.TOK_CHUNK,
                                      P.TOK_OW, j_pk[8])
    res_words, res_nw, res_cb = bitpack_v3(t_tr[3], t_tr[4], P.RES_CHUNK,
                                           P.RES_OW_FAST, j_pk[9])
    for g, w, n in zip((tok_words, tok_nw, res_words, res_nw, res_cb),
                       j_pk[:5], ("tok_words", "tok_nw", "res_words",
                                  "res_nw", "res_cb")):
        np.testing.assert_array_equal(_u(g), _u(w), err_msg=n)
    t_lf = TP._lf_pack_stream(tout["lf_res"], torch.tensor(lens),
                              torch.tensor(codes), False)
    for g, w, n in zip(t_lf, j_lf, ("lf_words", "lf_total", "hist_lf",
                                    "lf_tok_ok", "lf_fit_fast",
                                    "lf_fit_wide", "lf_cap_words")):
        np.testing.assert_array_equal(_u(torch.as_tensor(g)), _u(w),
                                      err_msg=n)

    got = TP.pack_payload(tout, torch.tensor(lens), torch.tensor(codes),
                          tok_classes=9, wide_residues=False)
    assert int(got[0]) == want_ok
    assert bool(j_pk[7]) is False or want_ok == 0     # res_okc
    if want_ok == 2:
        wide = TP.pack_payload(tout, torch.tensor(lens), torch.tensor(codes),
                               tok_classes=9, wide_residues=True)
        assert int(wide[0]) == 1
