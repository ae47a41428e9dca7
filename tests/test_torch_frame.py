"""The port's frame serializer (hydrium_tpu_torch/jxl/frame.py):
HFStream.add_group_padded's pure-Python branch takes the [n, 3, 64]
arrays of the unpacked fallback (its mask follows valid_len's rank) and
gives the native plane's bytes for them, and the two planes' LF group
sections agree."""

import numpy as np
import pytest

from hydrium_tpu_torch.jxl import native
from hydrium_tpu_torch.jxl.bitwriter import BitWriter
from hydrium_tpu_torch.jxl.frame import HFStream, write_lf_group


def _padded_group(rng, n):
    """Random padded [n, 3, 64] HF symbols: hybrid tokens of config
    (4, 1, 0) with matching residues, 9 clusters, ragged valid lengths."""
    valid_len = rng.integers(0, 65, (n, 3)).astype(np.int32)
    valid_len[:3] = [[0, 1, 64], [64, 0, 2], [1, 1, 1]]
    residue_bits = rng.integers(0, 12, (n, 3, 64)).astype(np.uint8)
    small = rng.random((n, 3, 64)) < 0.5
    residue_bits[small] = 0
    tokens = np.where(small, rng.integers(0, 16, (n, 3, 64)),
                      16 + 2 * (residue_bits.astype(np.int64) - 3)
                      + rng.integers(0, 2, (n, 3, 64)))
    tokens = np.clip(tokens, 0, 63).astype(np.uint16)
    residues = (rng.integers(0, 1 << 12, (n, 3, 64))
                & ((1 << residue_bits.astype(np.int64)) - 1)).astype(
                    np.uint32)
    clusters = rng.integers(0, 9, (n, 3, 64)).astype(np.uint8)
    return tokens, clusters, residues, residue_bits, valid_len


def _sections(use_native, group):
    hf = HFStream(1, use_native=use_native)
    hf.add_group_padded(*group, preset=0)
    hf.encode_group_sections()
    head = native.NativeBitWriter() if use_native else BitWriter()
    hf.write_hf_global(head, num_frame_groups=1)
    return [bytes(head.finalize())] + [bytes(w.finalize())
                                       for w in hf.group_sections]


@pytest.mark.parametrize("n,seed", [(64, 0), (1024, 1)])
def test_padded_group_python_branch_equals_native(n, seed):
    assert native.available()
    group = _padded_group(np.random.default_rng(seed), n)
    assert _sections(False, group) == _sections(True, group)


def test_lf_group_section_python_equals_native():
    rng = np.random.default_rng(3)
    lf_q = rng.integers(-3000, 3000, (40, 57, 3)).astype(np.int32)
    got = []
    for w in (BitWriter(), native.NativeBitWriter()):
        write_lf_group(w, lf_q)
        got.append(bytes(w.finalize()))
    assert got[0] == got[1]
