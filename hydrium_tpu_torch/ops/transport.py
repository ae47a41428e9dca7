"""Transport stage of the packed tail: the front's [N, 64] tensors ->
flat transport-coded token and residue streams plus the sampled
per-class token histogram.  Twin of the CPU branch of
hydrium_tpu/ops/pipeline.py _hf_transport_streams.

transport_prep is the wrapper of the CUDA kernel csrc/transport_prep.cu
(it replaces the TPU kernel ops/pallas/prep.py::transport_prep); on a
CPU tensor it runs transport_prep_plain, its plain torch twin.
"""

from __future__ import annotations

import torch

from . import _kernels
from .constants import HIST_SAMPLE_STRIDE


def _valid(valid_len: torch.Tensor) -> torch.Tensor:
    return (torch.arange(64, device=valid_len.device)[None, :]
            < valid_len[:, None])


def transport_prep_plain(tokens, clusters, valid_len, residues,
                         residue_bits, tok_len, tok_code, *,
                         tok_classes: int):
    """Plain twin of the transport_prep kernel: the CPU expressions of
    _hf_transport_streams.  Returns (t_flat i32 [u32 bits], t_bits i32,
    r_flat i32 [u32 bits], r_bits i32), each [64 N] in slot order."""
    M = valid_len.shape[0] * 64
    valid = _valid(valid_len).reshape(M)
    t_idx = torch.where(valid, (tokens.reshape(M).to(torch.int64) & 0xFFFF)
                        .clamp(max=63), 0)
    cls = clusters.reshape(M).to(torch.int64) % tok_classes
    ct = cls * 64 + t_idx
    t_flat = torch.where(valid, tok_code.to(torch.int64)[ct], 0)
    t_bits = tok_len.to(torch.int64)[ct] * valid
    r_flat = torch.where(valid, residues.reshape(M), 0)
    r_bits = torch.where(valid, residue_bits.reshape(M).to(torch.int32), 0)
    return (t_flat.to(torch.int32), t_bits.to(torch.int32),
            r_flat.to(torch.int32), r_bits)


def transport_prep(tokens, clusters, valid_len, residues, residue_bits,
                   tok_len, tok_code, *, tok_classes: int):
    """Per slot: transport code and length of the token under its class
    (cluster % tok_classes), residue word and width; all zero past the
    block-channel's valid length.  tokens i16 [u16 bits], clusters u8,
    residues i32 [u32 bits], residue_bits u8, all [N, 64]; valid_len i32
    [N]; tok_len/tok_code i32 [10*64].  CUDA tensors launch the kernel,
    CPU tensors take the plain twin."""
    if tokens.device.type == "cpu":
        return transport_prep_plain(tokens, clusters, valid_len, residues,
                                    residue_bits, tok_len, tok_code,
                                    tok_classes=tok_classes)
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
                or (shape is not None and tuple(t.shape) != shape)):
            raise ValueError(f"transport_prep: bad input {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; want {dt} "
                             f"{shape} contiguous on {tokens.device}")
    if not 1 <= tok_classes <= 9 or tok_len.numel() < 64 * tok_classes \
            or tok_code.numel() < 64 * tok_classes:
        raise ValueError(f"transport_prep: bad tok_classes {tok_classes}")
    M = N * 64
    dev = tokens.device
    t_flat = torch.empty(M, dtype=torch.int32, device=dev)
    t_bits = torch.empty(M, dtype=torch.int32, device=dev)
    r_flat = torch.empty(M, dtype=torch.int32, device=dev)
    r_bits = torch.empty(M, dtype=torch.int32, device=dev)
    rc = _kernels.lib().hyd_transport_prep(
        tokens.data_ptr(), clusters.data_ptr(), valid_len.data_ptr(),
        residues.data_ptr(), residue_bits.data_ptr(), tok_len.data_ptr(),
        tok_code.data_ptr(), tok_classes, N, t_flat.data_ptr(),
        t_bits.data_ptr(), r_flat.data_ptr(), r_bits.data_ptr(),
        _kernels.stream_ptr(tokens))
    _kernels.check(rc, "transport_prep")
    transport_prep.launches += 1
    return t_flat, t_bits, r_flat, r_bits


transport_prep.launches = 0


def hf_transport_streams(out, tok_len, tok_code, tok_classes: int):
    """Stage 1 of the packed tail.  Returns (t_flat, t_bits, hist64,
    r_flat, r_bits, tok_ok): the flat streams of transport_prep, the
    HS-sampled per-class token histogram i64 [9*64] (every HS-th
    block-channel row, counts scaled by HS) and whether every valid
    token fits the 64-symbol transport alphabet (bool tensor)."""
    tokens, clusters = out["tokens"], out["clusters"]
    valid_len = out["valid_len"]
    N = valid_len.shape[0]
    tok16 = tokens.to(torch.int64) & 0xFFFF
    valid = _valid(valid_len)
    tok_ok = torch.all(torch.where(valid, tok16, 0) < 64)

    t_flat, t_bits, r_flat, r_bits = transport_prep(
        tokens, clusters, valid_len, out["residues"], out["residue_bits"],
        tok_len, tok_code, tok_classes=tok_classes)

    HS = HIST_SAMPLE_STRIDE if N % HIST_SAMPLE_STRIDE == 0 else 1
    v_h = valid[::HS]
    t_h = torch.where(v_h, tok16[::HS].clamp(max=63), 0)
    c_h = clusters[::HS].to(torch.int64) % tok_classes
    hist64 = torch.zeros(9 * 64, dtype=torch.int64, device=tokens.device)
    hist64.index_add_(0, (c_h * 64 + t_h).reshape(-1),
                      v_h.reshape(-1).to(torch.int64))
    return t_flat, t_bits, hist64 * HS, r_flat, r_bits, tok_ok
