"""HF coefficient context modeling and hybrid-uint tokenization, fully
vectorized over blocks of a 256x256 group: the numpy plane's tokenizer
(the port's copy of hydrium_tpu/ops/hf_tokens.py).

Replicates the symbol/context stream of the reference's
initialize_hf_coeffs (encoder.c:670-750):

Per block (raster order), per channel in emission order Y,X,B:
  1. a nonzero-count symbol with context
        1485*preset + 3*nz_ctx(predicted) + block_ctx
     where predicted comes from the top/left neighbor blocks' counts
     (encoder.c:670-687), and block_ctx = emission index (0,1,2);
  2. for zig-zag index j = 1.. while nonzeros remain: the packed
     coefficient with context
        1485*preset + 458*block_ctx + 111 + prev
        + ((cnzc[remaining] + cfc[j]) << 1)
     prev = (j>1 ? coeff[j-1] != 0 : count<=4), remaining = nonzeros not
     yet emitted (sequential in the reference, a cumulative sum here).

The emission stops after the last nonzero coefficient; symbols are laid
out [blocks..., channel, 64] with slot 0 = the count symbol and a per
block-channel valid length, so downstream serializers walk the exact
stream without compaction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables
from .reference import pack_signed

# hybrid-uint config for the HF stream: split_exponent 4, msb 1, lsb 0
# (encoder.c:908)
_SPLIT_EXP = 4
_SPLIT = 1 << _SPLIT_EXP


def hybridize_u32(symbols: np.ndarray):
    """Vectorized hybrid-uint with config (4,1,0) -> (token, residue, bits).

    entropy.c:427-444 for the msb_in_token=1, lsb_in_token=0 case."""
    symbols = symbols.astype(np.uint32)
    small = symbols < _SPLIT
    x = np.maximum(symbols, _SPLIT)  # avoid log2(0) on the small lane
    n_total = (31 - _clz32(x))  # floor log2
    n = n_total - 1  # msb removed
    residue_bits = np.where(small, 0, n).astype(np.uint8)
    residue = np.where(small, 0, x & ((np.uint32(1) << n) - 1)).astype(np.uint32)
    high = (x >> n) & 1
    token_big = _SPLIT + (high | ((n - np.uint32(_SPLIT_EXP) + 1) << 1))
    token = np.where(small, symbols, token_big).astype(np.uint16)
    return token, residue, residue_bits


def _clz32(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint32 via float trick-free bit twiddling."""
    x = x.astype(np.uint32)
    n = np.zeros(x.shape, dtype=np.uint32)
    for shift in (16, 8, 4, 2, 1):
        mask = x >= (np.uint32(1) << shift)
        n = np.where(mask, n + shift, n)
        x = np.where(mask, x >> shift, x)
    return (31 - n).astype(np.int32)


def predicted_nonzeroes(nz: np.ndarray) -> np.ndarray:
    """Per-block predicted nonzero count from neighbors
    (encoder.c:670-678).  nz: [gbh, gbw, 3] -> same shape int32."""
    gbh, gbw, _ = nz.shape
    nz = nz.astype(np.int32)
    pred = np.empty_like(nz)
    # general: (above + left + 1) >> 1
    above = np.zeros_like(nz)
    above[1:] = nz[:-1]
    left = np.zeros_like(nz)
    left[:, 1:] = nz[:, :-1]
    pred = (above + left + 1) >> 1
    # first row: left neighbor only
    pred[0, 1:] = nz[0, :-1]
    # first column: the FIRST block of the previous row (encoder.c:674)
    pred[1:, 0] = nz[:-1, 0]
    pred[0, 0] = 32
    return pred


def nz_context(predicted: np.ndarray) -> np.ndarray:
    """encoder.c:680-687."""
    p = np.minimum(predicted, 64)
    return np.where(predicted < 8, predicted, 4 + (p >> 1)).astype(np.int32)


@dataclass
class GroupTokens:
    """Tokenized HF stream of one group, padded per block-channel.

    Arrays are [gbh, gbw, 3, 64]; emission order is C-order over
    (by, bx, channel, slot) masked to slot < valid_len."""

    tokens: np.ndarray        # uint16
    clusters: np.ndarray      # uint8 (context already mapped through cluster map)
    residues: np.ndarray      # uint32
    residue_bits: np.ndarray  # uint8
    valid_len: np.ndarray     # [gbh, gbw, 3] int32: 1 + last_nonzero_index

    @property
    def symbol_count(self) -> int:
        return int(self.valid_len.sum())

    def flatten(self):
        """Emission-order flat arrays (tokens, clusters, residues, bits)."""
        mask = (np.arange(64)[None, None, None, :]
                < self.valid_len[..., None])
        return (self.tokens[mask], self.clusters[mask],
                self.residues[mask], self.residue_bits[mask])


def tokenize_group(hf_q: np.ndarray, nz: np.ndarray, preset: int,
                   cluster_map: np.ndarray) -> GroupTokens:
    """Tokenize one group's HF coefficients.

    hf_q: [gbh, gbw, 64, 3] int32 zig-zag quantized coefficients
    nz:   [gbh, gbw, 3] int32 nonzero counts
    preset: histogram preset index of this group's LF group
    cluster_map: full context->cluster map (tables.hf_cluster_map)
    """
    gbh, gbw, _, _ = hf_q.shape
    # reorder channels: emission order Y, X, B <- storage X, Y, B
    q = hf_q[..., [1, 0, 2]].transpose(0, 1, 3, 2)  # [gbh, gbw, 3, 64]
    nzc = nz[..., [1, 0, 2]]                        # [gbh, gbw, 3]

    base = preset * tables.CONTEXTS_PER_PRESET
    block_ctx = np.arange(3, dtype=np.int32)[None, None, :]

    # --- slot 0: the nonzero-count symbol -----------------------------
    pred = predicted_nonzeroes(nzc)
    count_ctx = base + 3 * nz_context(pred) + block_ctx

    # --- slots 1..63: coefficient symbols -----------------------------
    nonzero = (q[..., 1:] != 0)
    # remaining[j] = count - (# nonzero among zig-zag 1..j-1); the
    # reference reads it before decrementing for the current coefficient.
    cum = np.cumsum(nonzero, axis=-1, dtype=np.int32)
    remaining = nzc[..., None] - np.concatenate(
        [np.zeros(q.shape[:3] + (1,), np.int32), cum[..., :-1]], axis=-1)
    prev = np.empty(nonzero.shape, dtype=np.int32)
    prev[..., 0] = (nzc <= 4)
    prev[..., 1:] = nonzero[..., :-1]
    hist = base + tables.COEFF_CONTEXTS_PER_BLOCK_CTX * block_ctx + 111
    j_idx = np.arange(1, 64)
    coeff_ctx = (hist[..., None] + prev
                 + ((tables.COEFF_NUM_NONZERO_CONTEXT[
                     np.clip(remaining, 0, 63)]
                     + tables.COEFF_FREQ_CONTEXT[j_idx]) << 1))

    # last nonzero zig-zag index per block-channel (0 when none)
    last_nz = np.where(nzc > 0, 63 - np.argmax(nonzero[..., ::-1], axis=-1),
                       0)
    valid_len = (1 + last_nz).astype(np.int32)

    # --- assemble padded [.., 3, 64] arrays ---------------------------
    values = np.empty(q.shape, dtype=np.uint32)
    values[..., 0] = nzc
    values[..., 1:] = pack_signed(q[..., 1:])
    contexts = np.empty(q.shape, dtype=np.int32)
    contexts[..., 0] = count_ctx
    contexts[..., 1:] = coeff_ctx

    tokens, residues, residue_bits = hybridize_u32(values)
    clusters = cluster_map[contexts].astype(np.uint8)
    return GroupTokens(tokens=tokens, clusters=clusters, residues=residues,
                       residue_bits=residue_bits, valid_len=valid_len)
