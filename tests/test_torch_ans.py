"""The HF ANS section encoder (csrc/host/serializer.cc ans_encode_slice,
through jxl/native.py NativeHF) against its Python twin
(jxl/entropy.py ans_encode_symbols): random symbol streams of several
histogram shapes at every log alphabet size, byte for byte with the
sections' tail bits.  Then the encoder's ans_symbols counter, which
must count what the walk counted, and jxlbench's ans_ns_per_sym
reader."""

import importlib.util
import os

import numpy as np
import pytest

import hydrium_tpu_torch
from hydrium_tpu_torch import ImageMetadata
from hydrium_tpu_torch.jxl import entropy, native
from hydrium_tpu_torch.jxl.bitwriter import BitWriter
from test_e2e import make_image
from test_torch_e2e import prep_pool_idle, warm_state  # noqa: F401
from test_torch_tiled import _tiles
from test_torch_walk import ROOT, _image, _window

N_CLUSTERS = 3
PRESET_BITS = 2


def _cluster_tokens(rng, shape: str, table: int, n: int) -> np.ndarray:
    """n tokens below `table` whose histogram has the given shape."""
    if shape == "one":        # a single token: all 4096 on it
        return np.full(n, rng.integers(table))
    if shape == "two":
        a, b = rng.choice(table, 2, replace=False)
        return np.where(rng.random(n) < rng.uniform(0.01, 0.99), a, b)
    if shape == "uniform":
        return rng.integers(rng.integers(2, table + 1), size=n)
    if shape == "dominant":   # one token >= 4000 of 4096
        rest = rng.integers(table, size=n)
        return np.where(rng.random(n) < 0.99, rest[0], rest)
    if shape == "bucket":     # each token at the bucket size, 4096 / table
        return rng.permutation(np.repeat(np.arange(table), n // table))
    weights = rng.pareto(1.0, table) * (rng.random(table) < 0.7) + 1e-3
    return rng.choice(table, n, p=weights / weights.sum())


def _stream(las: int, shape: str, seed: int):
    """Five groups of symbols over N_CLUSTERS clusters, with random
    residues of 0 to 20 bits.  The tokens of each cluster but the last
    have the shape; the last cluster's are random, so that the others
    meet states of every offset (a state that only a one-symbol cluster
    has touched keeps its low 12 bits)."""
    rng = np.random.default_rng(seed)
    table, n = 1 << las, 4096
    shapes = [shape] * (N_CLUSTERS - 1) + ["random"]
    tokens = np.concatenate([_cluster_tokens(rng, s, table, n)
                             for s in shapes])
    clusters = np.repeat(np.arange(N_CLUSTERS), n)
    order = rng.permutation(len(tokens))
    tokens, clusters = tokens[order], clusters[order]
    rbits = rng.integers(0, 21, len(tokens))
    residues = rng.integers(0, 1 << 20, len(tokens)) & ((1 << rbits) - 1)
    cuts = np.sort(rng.choice(np.arange(1, len(tokens)), 4, replace=False))
    return [tuple(a[lo:hi] for a in (tokens, clusters, residues, rbits))
            for lo, hi in zip([0, *cuts], [*cuts, len(tokens)])]


def _padded(a, dtype):
    """A group's flat symbols as the [blocks, 3, 64] arrays (and valid
    lengths) that NativeHF.add_group walks in order."""
    rows = -(-len(a) // 64)
    out = np.zeros(-(-rows // 3) * 3 * 64, dtype)
    out[:len(a)] = a
    valid = np.zeros(len(out) // 64, np.int32)
    valid[:rows] = 64
    valid[rows - 1] = len(a) - 64 * (rows - 1)
    return out.reshape(-1, 3, 64), valid.reshape(-1, 3)


def _native(groups, las: int, n_threads: int):
    hf = native.NativeHF(N_CLUSTERS)
    hf.force_las(las)
    for g, (t, c, r, b) in enumerate(groups):
        t16, valid = _padded(t, np.uint16)
        hf.add_group(t16, _padded(c, np.uint8)[0], _padded(r, np.uint32)[0],
                     _padded(b, np.uint8)[0], valid, g % 4)
    hf.prepare()
    freqs = [hf.frequencies(c).tolist() for c in range(N_CLUSTERS)]
    return freqs, [w.export_raw()
                   for w in hf.encode_all(PRESET_BITS, n_threads)]


def _python(groups, las: int):
    """The twin: count, normalize and build the alias tables over all the
    groups, as the native prepare does, then encode each group."""
    tokens = np.concatenate([g[0] for g in groups])
    clusters = np.concatenate([g[1] for g in groups])
    freqs, aliases = [], []
    for c in range(N_CLUSTERS):
        t = tokens[clusters == c]
        f = np.bincount(t, minlength=int(t.max()) + 1).tolist()
        uniq = entropy.normalize_ans_frequencies(f, len(f))
        freqs.append(f)
        aliases.append(entropy.generate_alias_mapping(
            f, len(f), las, len(f) - 1 if uniq else -1))
    sections = []
    for g, (t, c, r, b) in enumerate(groups):
        bw = BitWriter()
        bw.write(g % 4, PRESET_BITS)
        entropy.ans_encode_symbols(t.tolist(), c.tolist(), r.tolist(),
                                   b.tolist(), freqs, aliases, las, bw)
        sections.append(bw.export_raw())
    return freqs, sections


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", ["one", "two", "uniform", "dominant",
                                   "bucket", "random"])
@pytest.mark.parametrize("las", [5, 6, 7, 8])
def test_native_sections_equal_python_twin(las, shape, seed):
    groups = _stream(las, shape, 1000 * las + seed)
    want = _python(groups, las)
    shaped = want[0][:-1]
    if shape == "one":
        assert all(f[-1] == 4096 for f in shaped)
    if shape == "dominant":
        assert all(max(f) >= 4000 for f in shaped)
    if shape == "bucket":
        assert all(f == [4096 >> las] * (1 << las) for f in shaped)
    assert _native(groups, las, 1) == want
    assert _native(groups, las, 3) == want    # fewer threads than groups


@pytest.mark.parametrize("n_threads", [1, 8, 16])
def test_one_group_frame_sections_equal_at_any_thread_count(n_threads):
    """A one-group frame, as a 256x256 tile frame is, gives its twin's
    section whatever thread count it is asked for (it runs on the
    calling thread alone)."""
    groups = _stream(8, "random", 23)[:1]
    assert _native(groups, 8, n_threads) == _python(groups, 8)


@pytest.mark.parametrize("mode", ["streaming", "whole_frame", "tiled"])
def test_encodes_count_the_symbols_they_ans_encode(mode):
    """ans_symbols equals walk_symbols: on the drain worker, preset by
    preset (streaming), at the frame's finalize, and in tiled renders."""
    if mode == "tiled":
        img = make_image(300, 700, "noise", seed=15)
        enc = hydrium_tpu_torch.Encoder(
            ImageMetadata(width=700, height=300, tile_size_shift_x=0,
                          tile_size_shift_y=0), device="cpu")
        enc.send_tile_batch(_tiles(img, 256, 256))
    else:
        img = _image()
        enc = hydrium_tpu_torch.Encoder(
            ImageMetadata(width=img.shape[1], height=img.shape[0]),
            device="cpu", streaming=mode == "streaming")
        assert enc.streaming == (mode == "streaming")
        for tile, tx, ty in _tiles(img, 2048, 2048):
            enc.send_tile(tile, tx, ty)
    assert enc.take_output()
    prep_pool_idle()
    counters = enc.stats.counters
    assert counters["ans_symbols"] == counters["walk_symbols"] > 0


def _reader():
    path = os.path.join(ROOT, "jxlbench", "metrics", "ans_ns_per_sym.py")
    spec = importlib.util.spec_from_file_location("ans_ns_per_sym", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("images,value", [
    ([], None),
    ([({"ans_encode": 0.1}, {"walk_symbols": 4})], None),   # no counter
    ([({"ans_encode": 0.020, "walk": 0.5}, {"ans_symbols": 4_000_000}),
      ({"ans_encode": 0.016}, {"ans_symbols": 5_000_000})], 4.0)])
def test_ans_ns_per_sym_reader(images, value):
    got = _reader()(_window(*images))
    assert got == (None if value is None else pytest.approx(value))
