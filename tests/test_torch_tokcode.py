"""The transport code's native table builder (csrc/host/serializer.cc
hyd_tok_build_tables, bound as jxl/native.py tok_build_tables) against
its twin jxl/tokcode.py build_tables: lengths, codewords and decode
LUTs equal element for element, dtypes and shapes included."""

import numpy as np
import pytest

from hydrium_tpu_torch.jxl import native, tokcode
from hydrium_tpu_torch.jxl.tokcode import (ALPHABET, MAX_LEN, NROWS,
                                           TokenCodec, build_tables)


def _rows(value) -> np.ndarray:
    return np.tile(np.asarray(value, np.int64), (NROWS, 1))


def _random(seed: int) -> np.ndarray:
    """Histograms of several shapes: flat, sparse, heavy-tailed and
    spread over many magnitudes."""
    rng = np.random.default_rng(seed)
    shape = (NROWS, ALPHABET)
    kind = seed % 4
    if kind == 0:
        return rng.integers(0, 5000, shape)
    if kind == 1:
        return rng.integers(0, 3, shape)
    if kind == 2:
        return (rng.pareto(1.0, shape) * 100).astype(np.int64)
    return rng.integers(0, 1 << 40, shape) >> rng.integers(0, 40, shape)


def _spike() -> np.ndarray:
    f = np.zeros((NROWS, ALPHABET), np.int64)
    f[:, 5] = 1 << 40
    return f


def _decayed() -> np.ndarray:
    """A warm codec's state: the prior after ten folds of decaying,
    skewed histograms."""
    codec = TokenCodec()
    rng = np.random.default_rng(7)
    t = np.arange(ALPHABET)
    for step in range(10):
        scale = rng.uniform(1e3, 1e6) * rng.uniform(0.5, 0.95) ** t
        codec.update(rng.poisson(np.tile(scale, (NROWS, 1))))
    return codec.freqs


CASES = {
    "prior": tokcode._default_prior,
    "all_equal": lambda: _rows(np.full(ALPHABET, 777)),
    "all_zero": lambda: np.zeros((NROWS, ALPHABET), np.int64),
    "spike": _spike,
    # halving weights: the longest codes reach the 12-bit cap
    "geometric": lambda: _rows(
        np.int64(1) << np.maximum(62 - np.arange(ALPHABET), 0)),
    "decayed": _decayed,
    **{f"random{seed}": (lambda s=seed: _random(s)) for seed in range(200)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_tables_equal_build_tables(case):
    freqs = CASES[case]()
    got = native.tok_build_tables(freqs)
    want = build_tables(freqs)
    for name, a, b in zip(("lengths", "codewords", "luts"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=f"{case} {name}")
    if case == "geometric":
        assert got[0].max() == MAX_LEN


@pytest.mark.parametrize("bad", [-1, np.iinfo(np.int64).max])
def test_native_tables_refuse_a_frequency_out_of_range(bad):
    """A negative frequency, or one whose smoothed value int64 cannot
    hold, raises; the twin refuses both too."""
    freqs = tokcode._default_prior()
    freqs[3, 17] = bad
    with pytest.raises(RuntimeError):
        native.tok_build_tables(freqs)
    with pytest.raises(AssertionError):
        build_tables(freqs)


def test_codec_tables_equal_build_tables_across_updates():
    """TokenCodec.tables() builds with the native plane: its tables are
    the twin's on the prior and after each fold, built once per fold."""
    codec = TokenCodec()
    rng = np.random.default_rng(3)
    for step in range(3):
        assert not codec.built
        t = codec.tables()
        assert codec.built and codec.tables() is t
        for a, b in zip(t, build_tables(codec.freqs)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        codec.update(rng.integers(0, 5000, (NROWS, ALPHABET)))
