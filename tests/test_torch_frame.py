"""The port's frame serializer (hydrium_tpu_torch/jxl/frame.py):
HFStream.add_group_padded's pure-Python branch takes the [n, 3, 64]
arrays of the unpacked fallback (its mask follows valid_len's rank) and
gives the native plane's bytes for them, the two planes' LF group
sections agree, and the section store (FrameSections) lays a frame out
the same in RAM or spooled, whatever order its sections are put in."""

import os

import numpy as np
import pytest

from hydrium_tpu_torch.jxl import native
from hydrium_tpu_torch.jxl.bitwriter import BitWriter
from hydrium_tpu_torch.jxl.frame import (TOC_TABLE, FrameSections, HFStream,
                                         write_lf_group)


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


def _raw_sections(rng, n):
    """n raw sections (bytes, tail_val, tail_bits), some empty, some
    ending on a byte."""
    out = []
    for i in range(n):
        data = rng.integers(0, 256, int(rng.integers(0, 40))).astype(
            np.uint8).tobytes()
        tail_bits = int(rng.integers(0, 8)) if i % 3 else 0
        out.append((data, int(rng.integers(0, 1 << tail_bits)), tail_bits))
    return out


@pytest.mark.parametrize("order", ["in_order", "permuted"])
@pytest.mark.parametrize("spooled", [False, True], ids=["ram", "spooled"])
@pytest.mark.parametrize("multi_section", [False, True],
                         ids=["one_section", "several"])
def test_frame_sections_layout(tmp_path, multi_section, spooled, order):
    """The TOC and the bytes after it equal a plain BitWriter's layout:
    each section padded to a byte under its own TOC entry, or, in a
    one-group frame, all of them concatenated at bit level under one.
    The spool directory is gone when the bytes have been read, and
    after close()."""
    rng = np.random.default_rng(7)
    sections = _raw_sections(rng, 9)
    toc, body = BitWriter(), BitWriter()
    if multi_section:
        for data, tail_val, tail_bits in sections:
            toc.write_u32(TOC_TABLE, len(data) + (tail_bits > 0))
            body.append_bytes(data)
            body.write(tail_val, tail_bits)
            body.zero_pad()
    else:
        for data, tail_val, tail_bits in sections:
            for b in data:
                body.write(b, 8)
            body.write(tail_val, tail_bits)
        toc.write_u32(TOC_TABLE, (body.bit_position + 7) >> 3)
    want_toc, want_body = toc.finalize(), body.finalize()

    spool = str(tmp_path) if spooled else None
    spool_dirs = lambda: [d for d in os.listdir(tmp_path)
                          if d.startswith("hydspool-")]
    put = list(range(len(sections)))
    if order == "permuted":
        put = [int(i) for i in rng.permutation(put)]
    frame = FrameSections(multi_section, spool)
    for i in put:
        frame.add(sections[i], key=(i,))
    assert [k for k, _ in frame.items()] == [(i,) for i in range(9)]
    assert len(spool_dirs()) == (1 if spooled else 0)
    got_toc = BitWriter()
    got_toc.write(1, 3)          # write_toc pads to a byte first
    frame.write_toc(got_toc)
    assert got_toc.finalize() == b"\x01" + want_toc
    assert b"".join(frame.chunks()) == want_body
    assert not spool_dirs()
    abandoned = FrameSections(multi_section, spool)
    for i in put:
        abandoned.add(sections[i], key=(i,))
    abandoned.close()
    assert not spool_dirs()
