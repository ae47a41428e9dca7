"""Transport stage of the packed tail: the front's [N, 64] tensors ->
flat transport-coded token and residue streams, the sampled per-class
token histogram and the transport-alphabet flag.  Twin of the CPU branch
of hydrium_tpu/ops/pipeline.py _hf_transport_streams.

transport_prep is the wrapper of the CUDA kernel csrc/transport_prep.cu,
which computes the whole stage in one launch (it replaces the TPU kernel
ops/pallas/prep.py::transport_prep and the XLA passes around it); on a
CPU tensor it runs transport_prep_plain, its plain torch twin.
"""

from __future__ import annotations

import torch

from . import _kernels
from .constants import HIST_SAMPLE_STRIDE


def transport_prep_plain(tokens, clusters, valid_len, residues,
                         residue_bits, tok_len, tok_code, *,
                         tok_classes: int, hs: int):
    """Plain twin of the transport_prep kernel: the CPU expressions of
    _hf_transport_streams.  Returns (t_flat i32 [u32 bits], t_bits i32,
    hist i32 [9*64], r_flat i32 [u32 bits], r_bits i32, tok_ok bool []);
    the streams are [64 N] in slot order."""
    M = valid_len.shape[0] * 64
    valid = (torch.arange(64, device=valid_len.device)[None, :]
             < valid_len[:, None])
    tok16 = tokens.to(torch.int64) & 0xFFFF
    t_idx = torch.where(valid, tok16.clamp(max=63), 0)
    ct = (clusters.to(torch.int64) % tok_classes) * 64 + t_idx
    t_flat = torch.where(valid, tok_code.to(torch.int64)[ct], 0)
    t_bits = tok_len.to(torch.int64)[ct] * valid
    r_flat = torch.where(valid, residues, 0)
    r_bits = torch.where(valid, residue_bits.to(torch.int32), 0)
    tok_ok = torch.all(torch.where(valid, tok16, 0) < 64)
    # every hs-th block-channel row, counts scaled back by hs
    hist = torch.zeros(9 * 64, dtype=torch.int64, device=tokens.device)
    hist.index_add_(0, ct[::hs].reshape(-1),
                    valid[::hs].reshape(-1).to(torch.int64))
    return (t_flat.reshape(M).to(torch.int32),
            t_bits.reshape(M).to(torch.int32), (hist * hs).to(torch.int32),
            r_flat.reshape(M), r_bits.reshape(M), tok_ok)


def transport_prep(tokens, clusters, valid_len, residues, residue_bits,
                   tok_len, tok_code, *, tok_classes: int, hs: int):
    """Per slot: transport code and length of the token under its class
    (cluster % tok_classes), residue word and width, all zero past the
    block-channel's valid length; the per-class histogram of the valid
    tokens (clamped to 63) of every hs-th row, times hs; and whether
    every valid token is < 64.  tokens i16 [u16 bits], clusters u8,
    residues i32 [u32 bits], residue_bits u8, all [N, 64]; valid_len
    i32 [N]; tok_len/tok_code i32 [10*64].  CUDA tensors launch the
    kernel, CPU tensors take the plain twin."""
    if tokens.device.type == "cpu":
        return transport_prep_plain(tokens, clusters, valid_len, residues,
                                    residue_bits, tok_len, tok_code,
                                    tok_classes=tok_classes, hs=hs)
    if tokens.device.type != "cuda":
        raise ValueError(f"transport_prep: unsupported device {tokens.device}")
    N = valid_len.shape[0]
    want = ((tokens, torch.int16, (N, 64)), (clusters, torch.uint8, (N, 64)),
            (valid_len, torch.int32, (N,)), (residues, torch.int32, (N, 64)),
            (residue_bits, torch.uint8, (N, 64)),
            (tok_len, torch.int32, None), (tok_code, torch.int32, None))
    for t, dt, shape in want:
        if (t.device != tokens.device or t.dtype != dt
                or not t.is_contiguous()
                or (shape is not None and tuple(t.shape) != shape)
                or (shape == (N, 64) and t.data_ptr() % 16)):
            raise ValueError(f"transport_prep: bad input {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; want {dt} "
                             f"{shape} contiguous on {tokens.device} "
                             "([N, 64] arrays 16-byte aligned)")
    if not 1 <= tok_classes <= 9 or tok_len.numel() < 64 * tok_classes \
            or tok_code.numel() < 64 * tok_classes:
        raise ValueError(f"transport_prep: bad tok_classes {tok_classes}")
    if hs < 1:
        raise ValueError(f"transport_prep: bad hs {hs}")
    M = N * 64
    dev = tokens.device
    t_flat, t_bits, r_flat, r_bits = (
        torch.empty(M, dtype=torch.int32, device=dev) for _ in range(4))
    hist = torch.empty(9 * 64, dtype=torch.int32, device=dev)
    tok_ok = torch.empty((), dtype=torch.bool, device=dev)
    rc = _kernels.lib().hyd_transport_prep(
        tokens.data_ptr(), clusters.data_ptr(), valid_len.data_ptr(),
        residues.data_ptr(), residue_bits.data_ptr(), tok_len.data_ptr(),
        tok_code.data_ptr(), tok_classes, N, hs, t_flat.data_ptr(),
        t_bits.data_ptr(), r_flat.data_ptr(), r_bits.data_ptr(),
        hist.data_ptr(), tok_ok.data_ptr(), _kernels.stream_ptr(tokens))
    _kernels.check(rc, "transport_prep")
    transport_prep.launches += 1
    return t_flat, t_bits, hist, r_flat, r_bits, tok_ok


transport_prep.launches = 0


def hf_transport_streams(out, tok_len, tok_code, tok_classes: int):
    """Stage 1 of the packed tail: transport_prep over the front's
    outputs with the histogram row stride HS = HIST_SAMPLE_STRIDE where
    it divides N, else 1.  Returns (t_flat, t_bits, hist64, r_flat,
    r_bits, tok_ok)."""
    N = out["valid_len"].shape[0]
    hs = HIST_SAMPLE_STRIDE if N % HIST_SAMPLE_STRIDE == 0 else 1
    return transport_prep(out["tokens"], out["clusters"], out["valid_len"],
                          out["residues"], out["residue_bits"], tok_len,
                          tok_code, tok_classes=tok_classes, hs=hs)
