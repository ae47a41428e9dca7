"""The port's bit packing (hydrium_tpu_torch/ops/bitpack.py) against the
JAX package's CPU forms: chunk pack + overwrite_compact equals
pipeline._bitpack_v3(use_mxu=False) for the token and residue (fast and
wide) geometries, chunk_layout/bitpack_at equal their twins, and the LF
stream's bitpack/bitpack64 equal _bitpack/_bitpack64, all exactly; the
plain chunk-pack twin equals the Pallas kernel merge_pack_chunks (in
interpret mode) for every chunk that fits, and pack_chunk_streams on CPU
equals the plain twin per stream.  The CUDA chunk-pack kernel against
its plain twin is in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydrium_tpu.ops import pipeline as P
from hydrium_tpu.ops.pallas import bitpack as PB
from hydrium_tpu_torch.ops import bitpack as TB


def _fields(rng, F, cap, p, n_full=0):
    """values (u32) and widths <= cap, value < 2^width; zero-width
    fields mixed in; the first n_full fields at cap."""
    widths = np.minimum(rng.geometric(p, F), cap).astype(np.int64)
    widths[rng.random(F) < 0.3] = 0
    widths[:n_full] = cap
    vals = rng.integers(0, 1 << 32, F, dtype=np.int64) & ((1 << widths) - 1)
    return vals.astype(np.uint32), widths.astype(np.int32)


def _t(a):
    return torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u(x):
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32).astype(np.int64) if x.dtype == np.int32 \
        else x.astype(np.int64)


# (name, ch, ow, cap, geometric p, slack lanes, leading fields at cap):
# every chunk fits the budget the payload's ok word checks; a whole
# token chunk at the 12-bit cap still fits by construction
GEOMETRIES = [
    ("tokens", P.TOK_CHUNK, P.TOK_OW, P.TOK_MAX_LEN, 0.35, None,
     P.TOK_CHUNK),
    ("res_fast", P.RES_CHUNK, P.RES_OW_FAST, P.RES_CAP_FAST, 0.4,
     P.RES_LANES_FAST, 512),
    ("res_wide", P.RES_CHUNK, P.RES_OW_WIDE, P.RES_CAP_WIDE, 0.15,
     P.RES_LANES_WIDE, 512),
]


@pytest.mark.parametrize("name,ch,ow,cap,p,lanes,n_full", GEOMETRIES)
def test_chunk_stream_equals_bitpack_v3(name, ch, ow, cap, p, lanes,
                                        n_full):
    rng = np.random.default_rng(ch + ow + cap)
    R = 4
    vals, widths = _fields(rng, R * ch, cap, p, n_full)
    if lanes is None:          # token budget: 12 bits per slot
        num_words = R * ((P.TOK_MAX_LEN * ch) >> 5)
    else:
        num_words = R * (ow - lanes)
        assert widths.reshape(R, ch).sum(1).max() <= (ow - lanes) * 32
    want = P._bitpack_v3(jnp.asarray(vals), jnp.asarray(widths), ch, ow,
                         num_words, use_mxu=False, max_field_bits=cap)
    got = TB.bitpack_v3(_t(vals), _t(widths), ch, ow, num_words)
    for g, w, n in zip(got, want, ("words", "nw", "chunk_bits")):
        np.testing.assert_array_equal(_u(g), _u(w), err_msg=n)


@pytest.mark.parametrize("name,ch,ow,cap,p,lanes,n_full", GEOMETRIES)
def test_plain_pack_equals_pallas_merge_pack(name, ch, ow, cap, p, lanes,
                                             n_full):
    """pack_chunks_plain against the TPU kernel itself, run as
    tests/test_pallas_bitpack.py runs it: chunk_bits exactly equal, and
    rows exactly equal for every chunk that fits its ow words (past
    ow*32 the Pallas rows are garbage by contract)."""
    rng = np.random.default_rng(3 * ch + cap)
    R = 3
    vals, widths = _fields(rng, R * ch, cap, p, n_full)
    lanes_in, qbits = P._quad_fields(jnp.asarray(vals), jnp.asarray(widths),
                                     cap)
    want_rows, want_bits = PB.merge_pack_chunks(lanes_in, qbits, ch, ow, cap,
                                                interpret=True)
    rows, bits = TB.pack_chunks_plain(_t(vals), _t(widths), ch, ow)
    np.testing.assert_array_equal(_u(bits), _u(want_bits))
    fits = _u(bits) <= ow * 32
    assert fits.all()
    np.testing.assert_array_equal(_u(rows)[fits], _u(want_rows)[fits])


@pytest.mark.parametrize("res", ["res_fast", "res_wide"])
def test_pack_chunk_streams_cpu_equals_plain(res):
    """Tokens with fast or wide residues: the pair call on CPU equals the
    plain twin per stream, overflowing residue chunk included."""
    rng = np.random.default_rng(len(res))
    streams = []
    for name, ch, ow, cap, p, _lanes, n_full in GEOMETRIES:
        if name in ("tokens", res):
            vals, widths = _fields(rng, 5 * ch, cap, p, n_full)
            if name != "tokens":
                widths[ch:2 * ch] = cap
                vals[ch:2 * ch] = rng.integers(0, 1 << cap, ch)
            streams.append((_t(vals), _t(widths), ch, ow))
    got = TB.pack_chunk_streams(*streams)
    assert len(got) == 2
    for (chunks, bits), stream in zip(got, streams):
        want = TB.pack_chunks_plain(*stream)
        assert chunks.shape == (5, stream[3])
        assert torch.equal(chunks, want[0]) and torch.equal(bits, want[1])
    assert int(got[1][1][1]) > streams[1][3] * 32     # residue row 1 overflows


@pytest.mark.parametrize("num_words", [40, 4000])
def test_chunk_layout_and_bitpack_at_exact(num_words):
    """Including the JAX forms' edges: fields past num_words dropped, a
    carry past the end folded into the last word."""
    rng = np.random.default_rng(num_words)
    ch = 256
    vals, widths = _fields(rng, 8 * ch, 32, 0.1)
    off_w, nw_w, cb_w = P._chunk_layout(jnp.asarray(widths), ch)
    off_g, nw_g, cb_g = TB.chunk_layout(_t(widths), ch)
    for g, w, n in zip((off_g, nw_g, cb_g), (off_w, nw_w, cb_w),
                       ("off", "nw", "chunk_bits")):
        np.testing.assert_array_equal(_u(g), _u(w), err_msg=n)
    want = P._bitpack_at(jnp.asarray(vals), jnp.asarray(widths), off_w,
                         num_words)
    got = TB.bitpack_at(_t(vals), _t(widths), off_g, num_words)
    np.testing.assert_array_equal(_u(got), _u(want))


def test_overflow_chunk_bits_and_fitting_rows():
    """A chunk past its ow budget: chunk_bits stay exact; the rows that
    fit pack exactly as the JAX layout places them."""
    rng = np.random.default_rng(11)
    ch, ow, cap = P.RES_CHUNK, P.RES_OW_FAST, P.RES_CAP_WIDE
    vals, widths = _fields(rng, 3 * ch, cap, 0.5)
    widths[ch:2 * ch] = cap                  # row 1: 61440 bits > ow*32
    vals[ch:2 * ch] = rng.integers(0, 1 << cap, ch)
    chunks, cbits = TB.pack_chunks(_t(vals), _t(widths), ch, ow)
    off, nw, cb = P._chunk_layout(jnp.asarray(widths), ch)
    np.testing.assert_array_equal(_u(cbits), _u(cb))
    words = _u(P._bitpack_at(jnp.asarray(vals), jnp.asarray(widths), off,
                             int(np.asarray(nw).sum())))
    n0 = int(nw[0])
    np.testing.assert_array_equal(_u(chunks)[0, :n0], words[:n0])
    assert not _u(chunks)[0, n0:].any()
    assert (_u(chunks)[1] == words[n0:n0 + ow]).all()   # truncated at ow


@pytest.mark.parametrize("num_words", [3, 2000])
def test_lf_bitpack_exact(num_words):
    rng = np.random.default_rng(num_words + 1)
    vals, widths = _fields(rng, 3000, 32, 0.08)
    vals[5] = 9                     # value under a zero-width field
    widths[5] = 0
    want = P._bitpack(jnp.asarray(vals), jnp.asarray(widths), num_words)
    got = TB.bitpack(_t(vals), _t(widths), num_words)
    for g, w, n in zip(got, want, ("words", "total")):
        np.testing.assert_array_equal(_u(g), _u(w), err_msg=n)


@pytest.mark.parametrize("num_words", [5, 3000])
def test_lf_bitpack64_exact(num_words):
    rng = np.random.default_rng(num_words + 2)
    F = 2500
    widths = np.minimum(rng.geometric(0.05, F), 42).astype(np.int64)
    widths[:4] = [42, 0, 33, 64 - 22]
    full = rng.integers(0, 1 << 62, F, dtype=np.int64) & ((1 << widths) - 1)
    lo = (full & 0xFFFFFFFF).astype(np.uint32)
    hi = (full >> 32).astype(np.uint32)
    want = P._bitpack64(jnp.asarray(lo), jnp.asarray(hi),
                        jnp.asarray(widths.astype(np.int32)), num_words)
    got = TB.bitpack64(_t(lo), _t(hi), torch.tensor(widths), num_words)
    for g, w, n in zip(got, want, ("words", "total")):
        np.testing.assert_array_equal(_u(g), _u(w), err_msg=n)


def test_overwrite_compact_places_used_words():
    rng = np.random.default_rng(4)
    R, ow = 6, 16
    nw = np.array([3, 0, 16, 1, 5, 2])
    chunks = np.where(np.arange(ow)[None, :] < nw[:, None],
                      rng.integers(1, 1 << 31, (R, ow)), 0).astype(np.int32)
    got = TB.overwrite_compact(torch.tensor(chunks), torch.tensor(nw), 30)
    want = np.concatenate([chunks[r, :nw[r]] for r in range(R)])
    want = np.pad(want, (0, 30 - want.size))
    np.testing.assert_array_equal(got.numpy(), want)
