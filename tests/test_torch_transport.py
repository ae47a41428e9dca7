"""The port's transport stage (hydrium_tpu_torch/ops/transport.py)
against the JAX package: its plain twin equals the CPU branch of
pipeline._hf_transport_streams and the TPU kernel
ops/pallas/prep.py::transport_prep run in interpret mode, exactly,
including degenerate valid_len.  The CUDA kernel against the plain twin
is in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydrium_tpu.ops import pipeline as P
from hydrium_tpu.ops.pallas.prep import TR, pack_p16
from hydrium_tpu.ops.pallas.prep import transport_prep as pallas_prep
from hydrium_tpu_torch.ops import transport as TT


def _tables(rng):
    lens = rng.integers(1, 13, 10 * 64).astype(np.int32)
    codes = (rng.integers(0, 1 << 12, 10 * 64) & ((1 << lens) - 1)).astype(
        np.int32)
    return lens, codes


def _case(rng, N, tok_classes):
    tokens = rng.integers(0, 80, (N, 64)).astype(np.uint16)  # some >= 64
    clusters = rng.integers(0, 9 * 3, (N, 64)).astype(np.uint8)
    valid_len = rng.integers(0, 65, N).astype(np.int32)
    valid_len[:7] = [0, 1, 64, 64, 0, 33, 1]
    residue_bits = rng.integers(0, 31, (N, 64)).astype(np.uint8)
    residues = (rng.integers(0, 1 << 31, (N, 64), dtype=np.int64)
                & ((1 << residue_bits.astype(np.int64)) - 1)).astype(
                    np.uint32)
    lens, codes = _tables(rng)
    return {"tokens": tokens, "clusters": clusters, "valid_len": valid_len,
            "residues": residues, "residue_bits": residue_bits}, lens, codes


def _torch_out(out, device="cpu"):
    views = {"tokens": np.int16, "residues": np.int32}
    return {k: torch.tensor(v.view(views.get(k, v.dtype)), device=device)
            for k, v in out.items()}


def _i64(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x)
    return x.view(np.uint32).astype(np.int64) if x.dtype == np.int32 \
        else x.astype(np.int64)


@pytest.mark.parametrize("N", [TR, TR + 2])
@pytest.mark.parametrize("tok_classes", [9, 3, 2, 1])
def test_streams_equal_jax_cpu_branch(tok_classes, N):
    rng = np.random.default_rng(tok_classes * 10 + N)
    out, lens, codes = _case(rng, N, tok_classes)
    want = P._hf_transport_streams({k: jnp.asarray(v) for k, v in
                                    out.items()}, jnp.asarray(lens),
                                   jnp.asarray(codes), tok_classes)
    got = TT.hf_transport_streams(_torch_out(out), torch.tensor(lens),
                                  torch.tensor(codes), tok_classes)
    names = ("t_flat", "t_bits", "hist64", "r_flat", "r_bits", "tok_ok")
    for g, w, n in zip(got, want, names):
        np.testing.assert_array_equal(_i64(g), _i64(w), err_msg=n)


@pytest.mark.parametrize("tok_classes", [9, 3, 2, 1])
def test_plain_equals_pallas_interpret(tok_classes):
    rng = np.random.default_rng(41 + tok_classes)
    out, lens, codes = _case(rng, TR, tok_classes)
    p16 = pack_p16(jnp.asarray(out["tokens"]), jnp.asarray(out["clusters"]),
                   jnp.asarray(out["valid_len"]),
                   jnp.asarray(out["residue_bits"]), tok_classes)
    valid = np.arange(64)[None, :] < out["valid_len"][:, None]
    resm = jnp.asarray(np.where(valid, out["residues"], 0).astype(np.uint32))
    want = pallas_prep(p16, resm, jnp.asarray(lens), jnp.asarray(codes),
                       tok_classes=tok_classes, interpret=True)
    t = _torch_out(out)
    got = TT.transport_prep(t["tokens"], t["clusters"], t["valid_len"],
                            t["residues"], t["residue_bits"],
                            torch.tensor(lens), torch.tensor(codes),
                            tok_classes=tok_classes)
    for g, w, n in zip(got, want, ("t_flat", "t_bits", "r_flat", "r_bits")):
        np.testing.assert_array_equal(_i64(g), _i64(w), err_msg=n)


def test_cpu_tensors_take_plain_twin():
    rng = np.random.default_rng(3)
    out, lens, codes = _case(rng, 8, 9)
    t = _torch_out(out)
    before = TT.transport_prep.launches
    TT.transport_prep(t["tokens"], t["clusters"], t["valid_len"],
                      t["residues"], t["residue_bits"], torch.tensor(lens),
                      torch.tensor(codes), tok_classes=9)
    assert TT.transport_prep.launches == before
