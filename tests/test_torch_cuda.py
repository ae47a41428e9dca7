"""Tests of the port that need a CUDA card: each hand-written kernel
against its plain torch twin, and the whole encode on the card against
the same encode on the CPU.  They skip without a card.  This file
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import hydrium_tpu_torch
from hydrium_tpu.jxl.tokcode import TokenCodec
from hydrium_tpu.utils.stats import EncodeStats
from hydrium_tpu_torch.ops import bitpack as TB
from hydrium_tpu_torch.ops import constants as C
from hydrium_tpu_torch.ops import front as TF
from hydrium_tpu_torch.ops import transport as TT

pytestmark = pytest.mark.cuda

# quantized values the card's front may flip against the CPU front
# (float32 sums in another order, FMA contraction)
FLIP_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def _transport_inputs(rng, N, dev):
    tokens = rng.integers(0, 80, (N, 64)).astype(np.int16)  # some >= 64
    clusters = rng.integers(0, 27, (N, 64)).astype(np.uint8)
    valid_len = rng.integers(0, 65, N).astype(np.int32)
    valid_len[:7] = [0, 1, 64, 64, 0, 33, 1]
    rbits = rng.integers(0, 31, (N, 64)).astype(np.uint8)
    res = (rng.integers(0, 1 << 31, (N, 64), dtype=np.int64)
           & ((1 << rbits.astype(np.int64)) - 1)).astype(np.int32)
    lens, codes, _ = TokenCodec().tables()
    t = lambda a: torch.tensor(a, device=dev)
    return (t(tokens), t(clusters), t(valid_len), t(res), t(rbits),
            t(lens.astype(np.int32)), t(codes.astype(np.int32)))


@pytest.mark.parametrize("tok_classes", [9, 3, 1])
def test_transport_prep_kernel_equals_plain(cuda, tok_classes):
    args = _transport_inputs(np.random.default_rng(tok_classes), 4096, cuda)
    before = TT.transport_prep.launches
    got = TT.transport_prep(*args, tok_classes=tok_classes)
    want = TT.transport_prep_plain(*args, tok_classes=tok_classes)
    torch.cuda.synchronize()
    assert TT.transport_prep.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _fields(rng, F, cap, p, n_full, dev):
    widths = np.minimum(rng.geometric(p, F), cap).astype(np.int64)
    widths[rng.random(F) < 0.3] = 0
    widths[:n_full] = cap
    vals = rng.integers(0, 1 << 32, F, dtype=np.int64) & ((1 << widths) - 1)
    return (torch.tensor(vals.astype(np.uint32).view(np.int32), device=dev),
            torch.tensor(widths.astype(np.int32), device=dev))


@pytest.mark.parametrize("ch,ow,cap,p", [
    (C.TOK_CHUNK, C.TOK_OW, C.TOK_MAX_LEN, 0.35),
    (C.RES_CHUNK, C.RES_OW_FAST, C.RES_CAP_FAST, 0.4),
    (C.RES_CHUNK, C.RES_OW_WIDE, C.RES_CAP_WIDE, 0.15),
])
def test_chunk_pack_kernel_equals_plain(cuda, ch, ow, cap, p):
    """Two leading chunks with every field at cap overflow the residue
    geometries: the kernel must drop the same bits past ow*32."""
    vals, widths = _fields(np.random.default_rng(ch + cap), 64 * ch, cap, p,
                           2 * ch, cuda)
    before = TB.pack_chunks.launches
    got = TB.pack_chunks(vals, widths, ch, ow)
    want = TB.pack_chunks_plain(vals, widths, ch, ow)
    torch.cuda.synchronize()
    assert TB.pack_chunks.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("ch,ow,cap,p,lanes", [
    (C.TOK_CHUNK, C.TOK_OW, C.TOK_MAX_LEN, 0.35, 0),
    (C.RES_CHUNK, C.RES_OW_FAST, C.RES_CAP_FAST, 0.4, C.RES_LANES_FAST),
])
def test_chunk_stream_equals_layout_reference(cuda, ch, ow, cap, p, lanes):
    """Kernel + overwrite_compact on the card give the words of the
    format's reference layout (chunk_layout + bitpack_at) for chunks
    that fit their budget."""
    R = 48
    vals, widths = _fields(np.random.default_rng(ch * 7 + cap), R * ch,
                           cap, p, ch // 4, cuda)
    budget = (ow - lanes) * 32
    assert int(widths.view(R, ch).sum(1).max()) <= budget
    num_words = R * (budget >> 5)
    words, nw, chunk_bits = TB.bitpack_v3(vals, widths, ch, ow, num_words)
    off, nw_ref, cb_ref = TB.chunk_layout(widths, ch)
    ref = TB.bitpack_at(vals, widths, off, num_words)
    torch.cuda.synchronize()
    assert torch.equal(nw, nw_ref)
    assert torch.equal(chunk_bits.long(), cb_ref)
    assert torch.equal(words.long() & 0xFFFFFFFF, ref)


def test_wrappers_reject_bad_inputs(cuda):
    vals, widths = _fields(np.random.default_rng(1), 4096, 12, 0.3, 0, cuda)
    with pytest.raises(ValueError):
        TB.pack_chunks(vals.to(torch.int64), widths, 4096, 1552)
    with pytest.raises(ValueError):
        TB.pack_chunks(vals, widths, 3000, 1552)
    args = list(_transport_inputs(np.random.default_rng(2), 64, cuda))
    args[0] = args[0].to(torch.int32)
    with pytest.raises(ValueError):
        TT.transport_prep(*args, tok_classes=9)


def test_card_front_flip_rate(cuda):
    rng = np.random.default_rng(9)
    px = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        fe = TF.FrontEnd.from_tables().to(dev)
        outs.append([t.cpu() for t in fe(torch.tensor(px, device=dev), 512,
                                         512, buf_h=512, buf_w=512,
                                         linear_light=False,
                                         sample_kind="uint8")])
    (qg, lg), (qc, lc) = outs
    flips = int((qg != qc).sum()) + int((lg != lc).sum())
    assert flips <= FLIP_TOL * (qg.numel() + lg.numel()), flips


def test_card_encode_equals_cpu_encode_with_shared_front(cuda, monkeypatch):
    """With the front's integers taken from the CPU front in both runs,
    the card's kernels, payload, copy-back and walk must give the CPU
    path's bytes."""
    real = TF.front_tokens

    def cpu_front(front, pixels, *a, **k):
        out = real(TF.FrontEnd.from_tables(), pixels.cpu(), *a, **k)
        return {key: v.to(pixels.device) for key, v in out.items()}

    monkeypatch.setattr(TF, "front_tokens", cpu_front)
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (300, 2100, 3), dtype=np.uint8)
    want = hydrium_tpu_torch.encode_image(img, device="cpu")
    stats = EncodeStats()
    launches = (TT.transport_prep.launches, TB.pack_chunks.launches)
    got = hydrium_tpu_torch.encode_image(img, device="cuda", stats=stats)
    assert got == want
    assert stats.counters["lfg_packed"] == 2
    assert TT.transport_prep.launches - launches[0] == 2
    assert TB.pack_chunks.launches - launches[1] == 4
