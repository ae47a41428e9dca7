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
from hydrium_tpu_torch import EncodeStats
from hydrium_tpu_torch import encoder as TE
from hydrium_tpu_torch.jxl.tokcode import TokenCodec
from hydrium_tpu_torch.ops import bitpack as TB
from hydrium_tpu_torch.ops import constants as C
from hydrium_tpu_torch.ops import front as TF
from hydrium_tpu_torch.ops import frontend as TFE
from hydrium_tpu_torch.ops import graphs as TG
from hydrium_tpu_torch.ops import packed as TP
from hydrium_tpu_torch.ops import transport as TT

pytestmark = pytest.mark.cuda

# quantized values the card's front may flip against the CPU front
# (float32 sums in another order, FMA contraction), and the frontend
# kernel against its plain twin (also cbrtf against pow)
FLIP_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def warm_state(tmp_path, monkeypatch):
    """As test_torch_e2e's fixture (which this file cannot import: it
    runs where jax is absent): a cache path under tmp_path, no wide
    hints, a codec already warm, so launch counts hold no bootstrap."""
    codec = TokenCodec()
    codec.update(np.full((10, 64), 50))
    monkeypatch.setattr(TE, "_WARM_CACHE", str(tmp_path / "warm" / "warm.npz"))
    monkeypatch.setattr(TE, "_SHARED_CODEC", codec)
    monkeypatch.setattr(TE, "_WIDE_HINT", {})


def _transport_inputs(rng, N, dev, max_tok=80):
    """Stage inputs; by default some valid tokens are >= 64."""
    tokens = rng.integers(0, max_tok, (N, 64)).astype(np.int16)
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


def _assert_transport_equal(args, tok_classes, hs):
    """The kernel's six outputs equal the plain twin's, in one launch."""
    before = TT.transport_prep.launches
    got = TT.transport_prep(*args, tok_classes=tok_classes, hs=hs)
    want = TT.transport_prep_plain(*args, tok_classes=tok_classes, hs=hs)
    torch.cuda.synchronize()
    assert TT.transport_prep.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.parametrize("tok_classes", [9, 3, 1])
def test_transport_prep_kernel_equals_plain(cuda, tok_classes):
    args = _transport_inputs(np.random.default_rng(tok_classes), 4096, cuda)
    _assert_transport_equal(args, tok_classes, C.HIST_SAMPLE_STRIDE)


@pytest.mark.parametrize("case", ["rows_not_multiple_of_hs",
                                  "one_valid_token_ge_64"])
def test_transport_prep_kernel_edge_cases(cuda, case):
    """N = 3073 rows (hs 1, every row sampled) with all tokens < 64; and
    one valid token of 64 among tokens < 64 at N = 3072."""
    rng = np.random.default_rng(11)
    if case == "rows_not_multiple_of_hs":
        args = _transport_inputs(rng, 3073, cuda, max_tok=64)
        assert bool(_assert_transport_equal(args, 9, 1)[5])
    else:
        args = _transport_inputs(rng, 3072, cuda, max_tok=64)
        args[0][2, 5] = 64           # row 2 has valid_len 64
        assert not bool(_assert_transport_equal(args, 9, 4)[5])


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


def _res_geometry(wide):
    return ((C.RES_OW_WIDE, C.RES_CAP_WIDE, 0.15) if wide
            else (C.RES_OW_FAST, C.RES_CAP_FAST, 0.4))


def _assert_pair_equal(tok, res):
    """Both streams in one launch, each equal to the plain twin."""
    before = TB.pack_chunks.launches
    got = TB.pack_chunk_streams(tok, res)
    want = (TB.pack_chunks_plain(*tok), TB.pack_chunks_plain(*res))
    torch.cuda.synchronize()
    assert TB.pack_chunks.launches == before + 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape and torch.equal(a, b)
    return got


@pytest.mark.parametrize("wide", [False, True], ids=["fast", "wide"])
@pytest.mark.parametrize("r_tok,r_res", [(48, 96), (600, 1200)],
                         ids=["edge_tile", "above_two_waves"])
def test_chunk_pack_pair_equals_plain(cuda, r_tok, r_res, wide):
    """Tokens and residues of one dispatch in one launch: 144 chunks,
    fewer than the card's SMs, and 1800, more than two waves of the
    persistent grid.  Two leading residue chunks at cap overflow."""
    rng = np.random.default_rng(r_tok + wide)
    ow, cap, p = _res_geometry(wide)
    tok = _fields(rng, r_tok * C.TOK_CHUNK, C.TOK_MAX_LEN, 0.35, 0, cuda)
    res = _fields(rng, r_res * C.RES_CHUNK, cap, p, 2 * C.RES_CHUNK, cuda)
    _assert_pair_equal((*tok, C.TOK_CHUNK, C.TOK_OW),
                       (*res, C.RES_CHUNK, ow))


def _edge_chunks(rng, ch, ow, cap, p, dev):
    """Four chunks: one past ow*32 bits (every field at over 32*ow/ch
    bits), one of zero widths only, one of exactly ow*32 bits, one
    drawn as usual."""
    widths = np.minimum(rng.geometric(p, 4 * ch), cap).reshape(4, ch)
    widths[0] = 32 * ow // ch + 1
    widths[1] = 0
    exact = np.full(ch, 32 * ow // ch)
    exact[:32 * ow % ch] += 1
    widths[2] = rng.permutation(exact)
    assert widths[2].sum() == 32 * ow and widths[0].sum() > 32 * ow
    widths = widths.reshape(-1).astype(np.int64)
    vals = rng.integers(0, 1 << 32, 4 * ch, dtype=np.int64) & (
        (1 << widths) - 1)
    return (torch.tensor(vals.astype(np.uint32).view(np.int32), device=dev),
            torch.tensor(widths.astype(np.int32), device=dev), ch, ow)


@pytest.mark.parametrize("wide", [False, True], ids=["fast", "wide"])
def test_chunk_pack_pair_edge_chunks(cuda, wide):
    """In both streams: a chunk that overflows ow*32 (its bits past the
    row dropped, chunk_bits exact), a chunk whose widths are all zero
    (a zero row, chunk_bits 0) and a chunk of exactly ow*32 bits."""
    rng = np.random.default_rng(40 + wide)
    ow, cap, p = _res_geometry(wide)
    tok = _edge_chunks(rng, C.TOK_CHUNK, C.TOK_OW, C.TOK_MAX_LEN, 0.35, cuda)
    res = _edge_chunks(rng, C.RES_CHUNK, ow, cap, p, cuda)
    got = _assert_pair_equal(tok, res)
    for (chunks, bits), (_v, widths, ch, ow_s) in zip(got, (tok, res)):
        assert torch.equal(bits, widths.view(4, ch).sum(1).int())
        assert int(bits[0]) > 32 * ow_s and int(bits[2]) == 32 * ow_s
        assert not chunks[1].any() and int(bits[1]) == 0


def test_chunk_pack_rejects_misaligned_input(cuda):
    """The kernel loads with bulk copies: a view 4 bytes into its
    storage raises, in the one-stream and the pair call."""
    vals, widths = _fields(np.random.default_rng(3), C.TOK_CHUNK + 4,
                           C.TOK_MAX_LEN, 0.35, 0, cuda)
    F = C.TOK_CHUNK
    with pytest.raises(ValueError, match="aligned"):
        TB.pack_chunks(vals[1:F + 1], widths[:F], F, C.TOK_OW)
    with pytest.raises(ValueError, match="aligned"):
        TB.pack_chunk_streams(
            (vals[:F], widths[:F], F, C.TOK_OW),
            (vals[4:4 + 2048], widths[1:1 + 2048], 2048, C.RES_OW_FAST))


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
        TT.transport_prep(*args, tok_classes=9, hs=4)
    px = torch.zeros((300, 256, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):        # upload taller than the buffer
        TFE.frontend_lfg(px, 300, 256, buf_h=256, buf_w=256,
                         linear_light=False, sample_kind="uint8")


def _front_pixels(kind, h, w, upload, seed):
    """Samples of `kind` inside the true extent, zero outside.  "huge" is
    f32 with a fifth of the samples +-1e30 or +-1e25, so q saturates and
    the tokenizer sees values >= 2^31."""
    rng = np.random.default_rng(seed)
    px = np.zeros(upload + (3,), {"uint8": np.uint8,
                                  "uint16": np.uint16}.get(kind, np.float32))
    if kind == "uint8":
        px[:h, :w] = rng.integers(0, 256, (h, w, 3))
    elif kind == "uint16":
        px[:h, :w] = rng.integers(0, 65536, (h, w, 3))
    elif kind == "huge":
        s = rng.random((h, w, 3)).astype(np.float32)
        big = rng.random((h, w, 3)) < 0.2
        s[big] = rng.choice(np.float32([1e30, -1e30, 1e25, -1e25]),
                            int(big.sum()))
        px[:h, :w] = s
    else:
        px[:h, :w] = rng.random((h, w, 3)) ** 2.2
    return px


FRONT_SHAPES = [
    ("uint8", False, 2048, 2048, (2048, 2048), (2048, 2048)),  # one LFG
    ("uint8", False, 4096, 256, (4096, 256), (4096, 256)),     # tile stack
    ("uint16", False, 300, 520, (512, 768), (320, 544)),
    ("float32", True, 200, 300, (256, 512), (224, 320)),
    ("uint8", False, 112, 256, (256, 256), (128, 256)),        # edge tile
    # 16-bit samples at the LF groups of a 7680x4320 frame: a whole one
    # (G = 64), the right column (G = 48), the bottom row (224 of 256
    # rows uploaded, G = 8) and the corner (G = 6)
    ("uint16", False, 2048, 2048, (2048, 2048), (2048, 2048)),
    ("uint16", False, 2048, 1536, (2048, 1536), (2048, 1536)),
    ("uint16", False, 224, 2048, (256, 2048), (224, 2048)),
    ("uint16", False, 224, 1536, (256, 1536), (224, 1536)),
]
# and a saturating f32 linear upload (an edge tile), for the exact check
# only: summing +-1e10 cube roots in another order moves q by far more
# than a flip, so it has no place in the flip bounds against the twin
TOKENS_SHAPES = FRONT_SHAPES + [
    ("huge", True, 112, 256, (256, 256), (128, 256))]
STREAMS = ("tokens", "clusters", "residues", "residue_bits", "valid_len")


@pytest.mark.parametrize("kind,linear,h,w,buf,upload", FRONT_SHAPES)
def test_frontend_kernel_close_to_plain(cuda, kind, linear, h, w, buf,
                                        upload):
    px = torch.tensor(_front_pixels(kind, h, w, upload, h + w), device=cuda)
    kw = dict(buf_h=buf[0], buf_w=buf[1], linear_light=linear,
              sample_kind=kind)
    before = TFE.frontend_groups.launches
    q, lf = TFE.frontend_lfg(px, h, w, **kw)
    pq, plf = TFE.frontend_lfg_plain(px, h, w, **kw)
    torch.cuda.synchronize()
    assert TFE.frontend_groups.launches == before + 1
    assert q.shape == pq.shape and lf.shape == plf.shape
    flips = int((q != pq).sum()) + int((lf != plf).sum())
    assert flips <= FLIP_TOL * (q.numel() + lf.numel()), flips
    assert int((q - pq).abs().max()) <= 2
    assert int((lf - plf).abs().max()) <= 1


def test_frontend_kernel_masks_outside_true_extent(cuda):
    """Samples of the upload outside the true extent do not reach the
    outputs: they equal those of the same upload zeroed there."""
    px = _front_pixels("uint8", 112, 200, (128, 224), 7)
    junk = px.copy()
    junk[112:] = 255
    junk[:, 200:] = 255
    kw = dict(buf_h=256, buf_w=256, linear_light=False, sample_kind="uint8")
    q0, lf0 = TFE.frontend_lfg(torch.tensor(px, device=cuda), 112, 200, **kw)
    q1, lf1 = TFE.frontend_lfg(torch.tensor(junk, device=cuda), 112, 200,
                               **kw)
    assert torch.equal(q0, q1) and torch.equal(lf0, lf1)


def _tokens_args(kind, linear, h, w, buf, per):
    G = (buf[0] >> 8) * (buf[1] >> 8)
    presets = torch.arange(G, dtype=torch.int32) * 5 % 31
    return presets, dict(buf_h=buf[0], buf_w=buf[1], linear_light=linear,
                         sample_kind=kind, clusters_per_preset=per)


@pytest.mark.parametrize("per", [9, 3, 2, 1])
@pytest.mark.parametrize("kind,linear,h,w,buf,upload", TOKENS_SHAPES)
def test_frontend_tokens_kernel_equals_tokenizer_on_its_q(
        cuda, kind, linear, h, w, buf, upload, per):
    """The tokens epilogue equals tokenize_flat + the extent mask applied
    to the q/dc epilogue's q of the same input, exactly: both epilogues
    share one prologue, so q is the same bit for bit."""
    px = torch.tensor(_front_pixels(kind, h, w, upload, h + w), device=cuda)
    sample = "float32" if kind == "huge" else kind
    presets, kw = _tokens_args(sample, linear, h, w, buf, per)
    before = (TFE.frontend_tokens.launches, TFE.frontend_groups.launches)
    got = TFE.frontend_tokens(px, h, w, presets, **kw)
    q, lf = TFE.frontend_lfg(px, h, w, buf_h=buf[0], buf_w=buf[1],
                             linear_light=linear, sample_kind=sample)
    want = TF.tokenize_lfg(q, presets.to(cuda), h, w, buf_h=buf[0],
                           buf_w=buf[1], clusters_per_preset=per,
                           tabs=TFE._tables(cuda))
    torch.cuda.synchronize()
    assert (TFE.frontend_tokens.launches - before[0],
            TFE.frontend_groups.launches - before[1]) == (1, 1)
    assert torch.equal(got["lf_q"], lf)
    for k in STREAMS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), (k, int((got[k] != want[k])
                                                     .sum()))
    if kind == "huge":
        # q saturates, and hybridize's int32 view of values >= 2^31
        # gives 16-bit tokens (>= 2^15) without a residue
        assert bool((q == torch.iinfo(torch.int32).max).any())
        assert bool((got["tokens"] < 0).any())


@pytest.mark.parametrize("kind,linear,h,w,buf,upload", FRONT_SHAPES)
def test_frontend_tokens_kernel_close_to_plain(cuda, kind, linear, h, w,
                                               buf, upload):
    """Against the plain twin on the card, a flipped q value changes only
    its own block-channel row: rows that differ stay within the q flip
    bound."""
    px = torch.tensor(_front_pixels(kind, h, w, upload, h + w), device=cuda)
    presets, kw = _tokens_args(kind, linear, h, w, buf, 9)
    got = TFE.frontend_tokens(px, h, w, presets, **kw)
    want = TFE.frontend_tokens_plain(px, h, w, presets.to(cuda), **kw)
    torch.cuda.synchronize()
    rows = torch.zeros_like(got["valid_len"], dtype=torch.bool)
    for k in STREAMS:
        d = got[k] != want[k]
        rows |= d if d.dim() == 1 else d.any(dim=1)
    n_q = rows.numel() * 64
    assert int(rows.sum()) <= FLIP_TOL * n_q, int(rows.sum())
    assert int((got["lf_q"] - want["lf_q"]).abs().max()) <= 1


def test_frontend_tokens_kernel_masks_outside_true_extent(cuda):
    """Samples of the upload outside the true extent do not reach the
    streams, and valid_len is 0 for blocks outside the varblock extent."""
    px = _front_pixels("uint8", 112, 200, (128, 224), 7)
    junk = px.copy()
    junk[112:] = 255
    junk[:, 200:] = 255
    presets, kw = _tokens_args("uint8", False, 112, 200, (256, 256), 9)
    a = TFE.frontend_tokens(torch.tensor(px, device=cuda), 112, 200,
                            presets, **kw)
    b = TFE.frontend_tokens(torch.tensor(junk, device=cuda), 112, 200,
                            presets, **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    vl = a["valid_len"].reshape(32, 32, 3)
    assert int(vl[14:].abs().sum()) == 0 and int(vl[:, 25:].abs().sum()) == 0
    assert int((vl[:14, :25] > 0).sum()) > 0


@pytest.mark.parametrize("kind,offset", [("uint8", 0), ("uint8", 1),
                                         ("uint16", 0), ("float32", 1)])
def test_frontend_kernel_rows_not_16_byte_aligned(cuda, kind, offset):
    """A 200x250 upload (rows of 750, 1500 or 3000 bytes), also starting
    `offset` samples into its storage: the kernel copies the pieces that
    are not 16-byte aligned itself, with the same results."""
    host = _front_pixels(kind, 200, 250, (200, 250), 13)
    flat = torch.zeros(offset + host.size, dtype=torch.from_numpy(host).dtype,
                       device=cuda)
    flat[offset:] = torch.from_numpy(host.reshape(-1)).to(cuda)
    px = flat[offset:].view(200, 250, 3)
    linear = kind == "float32"
    kw = dict(buf_h=256, buf_w=256, linear_light=linear, sample_kind=kind)
    q, lf = TFE.frontend_lfg(px, 200, 250, **kw)
    pq, plf = TFE.frontend_lfg_plain(px, 200, 250, **kw)
    presets, tkw = _tokens_args(kind, linear, 200, 250, (256, 256), 9)
    got = TFE.frontend_tokens(px, 200, 250, presets, **tkw)
    want = TF.tokenize_lfg(q, presets.to(cuda), 200, 250, buf_h=256,
                           buf_w=256, clusters_per_preset=9,
                           tabs=TFE._tables(cuda))
    torch.cuda.synchronize()
    flips = int((q != pq).sum()) + int((lf != plf).sum())
    assert flips <= FLIP_TOL * (q.numel() + lf.numel()), flips
    assert torch.equal(got["lf_q"], lf)
    for k in STREAMS:
        assert torch.equal(got[k], want[k]), k


def test_frontend_tokens_rejects_bad_presets(cuda):
    px = torch.zeros((256, 512, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        TFE.frontend_tokens(px, 256, 512, torch.zeros(3, dtype=torch.int32),
                            buf_h=256, buf_w=512, linear_light=False,
                            sample_kind="uint8", clusters_per_preset=9)


def test_frontend_groups_layout_on_card(cuda):
    px = torch.tensor(_front_pixels("uint8", 256, 256, (256, 256), 3),
                      device=cuda)
    groups = torch.stack([px, px.flip(0), px.flip(1)])
    q, dc = TFE.frontend_groups(groups, linear_light=False,
                                sample_kind="uint8")
    pq, pdc = TFE.frontend_groups_plain(groups, linear_light=False,
                                        sample_kind="uint8")
    assert q.shape == (3, 1024, 3, 64) and dc.shape == (3, 32, 32, 3)
    flips = int((q != pq).sum()) + int((dc != pdc).sum())
    assert flips <= FLIP_TOL * (q.numel() + dc.numel()), flips


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


def _eager_on_card(front, pixels, height, width, presets, tok_len, tok_code,
                   **kw):
    return TP.encode_lfg_packed(front, pixels, height, width, presets,
                                tok_len.to(pixels.device),
                                tok_code.to(pixels.device), **kw)


def _patch_cpu_front(monkeypatch):
    """The front's integers from the CPU front, and so the eager packed
    pipeline on the card in place of the dispatch's graph (a front on
    the host cannot be captured; the graph tests below hold the graphs
    to the eager pipeline word for word)."""
    real = TF.front_tokens

    def cpu_front(front, pixels, *a, **k):
        out = real(TF.FrontEnd.from_tables(), pixels.cpu(), *a, **k)
        return {key: v.to(pixels.device) for key, v in out.items()}

    monkeypatch.setattr(TF, "front_tokens", cpu_front)
    monkeypatch.setattr(TG, "encode_lfg_packed", _eager_on_card)


def test_card_encode_equals_cpu_encode_with_shared_front(cuda, monkeypatch):
    """With the front's integers taken from the CPU front in both runs,
    the card's kernels, payload, copy-back and walk must give the CPU
    path's bytes."""
    _patch_cpu_front(monkeypatch)
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (300, 2100, 3), dtype=np.uint8)
    want = hydrium_tpu_torch.encode_image(img, device="cpu")
    stats = EncodeStats()
    launches = (TT.transport_prep.launches, TB.pack_chunks.launches)
    got = hydrium_tpu_torch.encode_image(img, device="cuda", stats=stats)
    assert got == want
    assert stats.counters["lfg_packed"] == 2
    assert TT.transport_prep.launches - launches[0] == 2
    assert TB.pack_chunks.launches - launches[1] == 2


def test_card_u16_encode_equals_cpu_encode_with_shared_front(cuda,
                                                            monkeypatch):
    """16-bit samples through pinned staging, the upload and the kernels:
    with the front's integers from the CPU front, the card's bytes equal
    the CPU's, for a full LF group beside a 224-row one."""
    _patch_cpu_front(monkeypatch)
    img = np.random.default_rng(16).integers(0, 65536, (224, 3000, 3),
                                             dtype=np.uint16)
    want = hydrium_tpu_torch.encode_image(img, device="cpu")
    stats = EncodeStats()
    got = hydrium_tpu_torch.encode_image(img, device="cuda", stats=stats)
    assert got == want
    assert stats.counters["lfg_packed"] == 2


def test_card_tiled_encode_equals_cpu_encode_with_shared_front(cuda,
                                                              monkeypatch):
    """Tiled mode (stacked chunks and edge tiles) with the front's
    integers from the CPU front: the card's bytes equal the CPU's."""
    _patch_cpu_front(monkeypatch)
    img = np.random.default_rng(5).integers(0, 256, (600, 1100, 3),
                                            dtype=np.uint8)
    want = hydrium_tpu_torch.encode_image(img, 0, device="cpu")
    stats = EncodeStats()
    got = hydrium_tpu_torch.encode_image(img, 0, device="cuda", stats=stats)
    assert got == want
    # rows of 4 full tiles and one edge tile, the last row all edges
    assert stats.counters["lfg_packed"] == 2 + 2 + 5


@pytest.mark.parametrize("fused", [False, True])
def test_card_sharded_over_two_entries_equals_encode_image(cuda, fused):
    """Three LF groups (one of them 4 columns wide) over two entries of
    the card: encode_image's bytes on the card, with the same front."""
    from hydrium_tpu_torch.parallel.driver import encode_image_sharded

    img = np.random.default_rng(6).integers(0, 256, (300, 4100, 3),
                                            dtype=np.uint8)
    want = hydrium_tpu_torch.encode_image(img, device="cuda",
                                          fused_front=fused)
    stats = EncodeStats()
    got = encode_image_sharded(img, ["cuda:0", "cuda:0"], stats=stats,
                               fused_front=fused)
    assert got == want
    assert stats.counters["lfg_packed"] == 3


def test_card_dryrun_multichip(cuda):
    """n = 8 on eight entries of the card: the symbol count of the same
    dry run on the CPU, within the front's flip bound."""
    from hydrium_tpu_torch.parallel.dryrun import dryrun_multichip

    want, _ = dryrun_multichip(8, ["cpu"] * 8)
    syms, nbytes = dryrun_multichip(8, ["cuda:0"] * 8)
    assert abs(syms - want) <= FLIP_TOL * want
    assert nbytes > 0


# -- CUDA graphs of the packed pipeline (ops/graphs.py) ----------------

# (kind, linear, h, w, tile_count_y, tile_count_x, lf_seg_vb): every
# dispatch shape of a one-frame 4K encode, the tiled stacked chunk and
# edge tile, an 8K u16 LF group (and its corner) and an f32 linear frame
GRAPH_SHAPES = [
    ("uint8", False, 2048, 2048, 8, 8, 0),
    ("uint8", False, 2048, 1792, 8, 8, 0),
    ("uint8", False, 112, 2048, 8, 8, 0),
    ("uint8", False, 112, 1792, 8, 8, 0),
    ("uint8", False, 4096, 256, 16, 1, 32),
    ("uint8", False, 112, 256, 1, 1, 0),
    ("uint16", False, 2048, 2048, 8, 8, 0),
    ("uint16", False, 224, 1536, 8, 8, 0),
    ("float32", True, 768, 1024, 8, 8, 0),
]


def _graph_inputs(dev, kind, linear, h, w, tcy, tcx, seg, *, seed=0,
                  preset=0, codec_seed=None, wide=False, fused=False):
    """(args, kw) of one dispatch as _TorchDispatch makes it."""
    from hydrium_tpu_torch.jxl.frame import LFGroupGeometry

    lfg = LFGroupGeometry(x=0, y=0, width=w, height=h, tile_count_x=tcx,
                          tile_count_y=tcy)
    buf_h, buf_w, uh, uw = TE.buffer_shapes(lfg)
    px = torch.tensor(_front_pixels(kind, h, w, (uh, uw), seed), device=dev)
    G = (buf_h >> 8) * (buf_w >> 8)
    presets = torch.full((G,), preset, dtype=torch.int32, device=dev)
    codec = TokenCodec()
    if codec_seed is not None:
        codec.update(np.random.default_rng(codec_seed).integers(
            0, 500, (10, 64)))
    lens, codes, _ = codec.tables()
    tabs = torch.from_numpy(np.stack([lens, codes]).astype(np.int32))
    tabs = tabs.pin_memory()
    kw = dict(buf_h=buf_h, buf_w=buf_w, linear_light=linear,
              sample_kind=kind, lf_seg_vb=seg, tok_classes=9,
              wide_residues=wide, fused=fused)
    return (px, h, w, presets, tabs[0], tabs[1]), kw


def _eager(front, args, kw):
    px, h, w, presets, tl, tc = args
    return TP.encode_lfg_packed(front, px, h, w, presets, tl.to(px.device),
                                tc.to(px.device), **kw)


@pytest.fixture
def graph_cache(cuda, monkeypatch):
    """A graph cache of this test's own."""
    cache = TG.GraphCache()
    monkeypatch.setattr(TG, "_CACHE", cache)
    yield cache
    cache.clear()


@pytest.mark.parametrize("fused", [False, True], ids=["torch", "fused"])
@pytest.mark.parametrize("kind,linear,h,w,tcy,tcx,seg", GRAPH_SHAPES)
def test_graph_payload_equals_eager(graph_cache, kind, linear, h, w, tcy,
                                    tcx, seg, fused):
    """Graph against eager word for word at each key: its first dispatch
    eager, its second captured and replayed, two more replayed, each
    with other pixels, presets and code tables (the bootstrap's table
    change between replays)."""
    front = TF.FrontEnd.from_tables().to("cuda")
    shape = (kind, linear, h, w, tcy, tcx, seg)
    for seed, codec_seed in ((1, None), (2, 7), (3, 8), (4, 9)):
        args, kw = _graph_inputs("cuda", *shape, seed=seed, preset=seed % 2,
                                 codec_seed=codec_seed, fused=fused)
        want = _eager(front, args, kw)
        got = TG.encode_lfg_packed(front, *args, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)
    st = TG.graph_stats()["cuda:0"]
    assert (st["eager"], st["captures"], st["replays"], st["live"]) == (
        1, 1, 3, 1)


@pytest.mark.parametrize("fused", [False, True], ids=["torch", "fused"])
def test_graph_wide_geometry_equals_eager(graph_cache, fused):
    """The wide residue geometry is a key of its own, equal to eager."""
    front = TF.FrontEnd.from_tables().to("cuda")
    for wide in (False, True):
        for seed in (4, 5, 6):
            args, kw = _graph_inputs("cuda", "uint8", False, 2048, 2048, 8,
                                     8, 0, seed=seed, wide=wide, fused=fused)
            assert torch.equal(TG.encode_lfg_packed(front, *args, **kw),
                               _eager(front, args, kw))
    st = TG.graph_stats()["cuda:0"]
    assert (st["captures"], st["replays"], st["live"]) == (2, 4, 2)


@pytest.mark.parametrize("kind,linear,h,w,tcy,tcx,seg", GRAPH_SHAPES)
def test_graph_body_never_waits_on_the_device(cuda, kind, linear, h, w,
                                              tcy, tcx, seg):
    """No operation of the eager body syncs with the host (what a
    capture cannot hold): one warm call, then both fronts under
    torch.cuda.set_sync_debug_mode("error")."""
    front = TF.FrontEnd.from_tables().to(cuda)
    runs = []
    for fused in (False, True):
        args, kw = _graph_inputs(cuda, kind, linear, h, w, tcy, tcx, seg,
                                 fused=fused)
        dev_args = args[:4] + tuple(t.to(cuda) for t in args[4:])
        TP.encode_lfg_packed(front, *dev_args, **kw)
        runs.append((dev_args, kw))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for dev_args, kw in runs:
            TP.encode_lfg_packed(front, *dev_args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_graph_interleaved_keys_and_payloads_in_flight(graph_cache):
    """Two keys in turns, every payload enqueued before any is read (of
    each key one eager, then four from its graph): each equals its eager
    payload."""
    front = TF.FrontEnd.from_tables().to("cuda")
    shapes = [("uint8", False, 2048, 1792, 8, 8, 0),
              ("uint8", False, 112, 256, 1, 1, 0)]
    cases = [_graph_inputs("cuda", *shapes[i % 2], seed=i, preset=i % 2,
                           codec_seed=i, fused=i % 2 == 0)
             for i in range(10)]
    got = [TG.encode_lfg_packed(front, *args, **kw) for args, kw in cases]
    for (args, kw), g in zip(cases, got):
        assert torch.equal(g, _eager(front, args, kw))
    st = TG.graph_stats()["cuda:0"]
    assert (st["eager"], st["captures"], st["replays"]) == (2, 2, 8)


def test_graph_replay_counts_captured_launches(graph_cache):
    """Each dispatch of a key raises the counters by its launches, be it
    eager (the first), the capture and its replay (the second) or a
    replay: one of each kernel for the fused front, none of
    frontend_tokens for the default front."""
    front = TF.FrontEnd.from_tables().to("cuda")
    wrappers = (TT.transport_prep, TB.pack_chunks, TFE.frontend_tokens,
                TFE.frontend_groups)
    for fused in (False, True):
        args, kw = _graph_inputs("cuda", "uint8", False, 112, 256, 1, 1, 0,
                                 fused=fused)
        for _ in range(4):
            before = [f.launches for f in wrappers]
            TG.encode_lfg_packed(front, *args, **kw)
            rose = [f.launches - b for f, b in zip(wrappers, before)]
            assert rose == [1, 1, int(fused), 0], (fused, rose)


def test_graph_replays_launch_the_counted_kernels(graph_cache):
    """What the counters add for a replay is what the card runs: a
    torch.profiler trace of three replays of a graph captured before the
    trace began sees each kernel launched as often as the counters
    rose."""
    from torch.profiler import ProfilerActivity, profile

    front = TF.FrontEnd.from_tables().to("cuda")
    args, kw = _graph_inputs("cuda", "uint8", False, 112, 256, 1, 1, 0,
                             fused=True)
    for _ in range(2):              # eager, then the capture
        TG.encode_lfg_packed(front, *args, **kw)
    torch.cuda.synchronize()
    wrappers = (TT.transport_prep, TB.pack_chunks, TFE.frontend_tokens)
    before = [f.launches for f in wrappers]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            TG.encode_lfg_packed(front, *args, **kw)
        torch.cuda.synchronize()
    rose = [f.launches - b for f, b in zip(wrappers, before)]
    seen = [sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.name)
            for name in ("transport_prep_kernel",
                         "chunk_pack_streams_kernel", "frontend_kernel")]
    assert rose == [3, 3, 3] and seen == rose, (rose, seen)


def test_graph_replays_keep_device_memory_steady(graph_cache):
    """After the capture, a replay allocates nothing but the clone it
    returns: the growth is the clones, each in a block the allocator may
    round up by less than 2 MiB (it does not split off a remainder of up
    to 1 MiB), where one eager dispatch allocates hundreds of MiB."""
    front = TF.FrontEnd.from_tables().to("cuda")
    args, kw = _graph_inputs("cuda", "uint8", False, 2048, 2048, 8, 8, 0,
                             fused=True)
    for _ in range(2):              # eager, then the capture
        TG.encode_lfg_packed(front, *args, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    outs = []
    for _ in range(3):
        outs.append(TG.encode_lfg_packed(front, *args, **kw))
        torch.cuda.synchronize()
        clones = sum(o.numel() * o.element_size() for o in outs)
        grown = torch.cuda.memory_allocated() - base
        assert clones <= grown < clones + len(outs) * 2 ** 21, (grown, clones)
    assert graph_cache.stats()["cuda:0"]["graphs"][0]["reserved_mib"] > 0


def test_graph_capture_error_reaches_the_caller(cuda, monkeypatch):
    """An operation that syncs with the host cannot be captured: the
    key's first dispatch runs it eagerly, its second (the cold codec's
    bootstrap, or the next encode) raises, and nothing runs the eager
    pipeline in its place."""
    monkeypatch.setattr(TG, "_CACHE", TG.GraphCache())
    real = TP.pack_payload

    def syncing(out, *a, **k):
        if int(out["valid_len"].sum()) < 0:     # a device-to-host read
            raise AssertionError
        return real(out, *a, **k)

    monkeypatch.setattr(TP, "pack_payload", syncing)
    img = np.random.default_rng(7).integers(0, 256, (300, 400, 3),
                                            dtype=np.uint8)
    with pytest.raises(RuntimeError):
        for _ in range(2):
            hydrium_tpu_torch.encode_image(img, device="cuda")
    assert TG.graph_stats() == {"cuda:0": {
        "eager": 1, "captures": 0, "replays": 0, "evictions": 0, "live": 0,
        "reserved_mib": 0.0, "graphs": []}}


def test_spans_mirrored_in_a_device_trace_while_keys_capture(graph_cache,
                                                            tmp_path):
    """An encode inside device_trace, with its timeline on, while its
    dispatch keys are captured for the first time (their second
    dispatch), then one that replays them: the captures and replays
    succeed, both files equal the encode made without the profiler,
    and the Chrome trace holds every tagged span, as often as the
    timeline, each thread's spans on one row of their own, beside the
    kernels."""
    import json
    from collections import Counter

    from hydrium_tpu_torch.utils.stats import device_trace

    img = np.random.default_rng(4).integers(0, 256, (300, 2100, 3),
                                            dtype=np.uint8)
    want = hydrium_tpu_torch.encode_image(img, device="cuda")
    eager = TG.graph_stats()["cuda:0"]["eager"]
    stats = EncodeStats()
    stats.enable_timeline()
    with device_trace(str(tmp_path)) as path:
        got = hydrium_tpu_torch.encode_image(img, device="cuda", stats=stats)
        again = hydrium_tpu_torch.encode_image(img, device="cuda")
        torch.cuda.synchronize()
    assert got == want and again == want
    st = TG.graph_stats()["cuda:0"]
    assert st["captures"] == eager == st["live"] >= 2
    assert st["replays"] == 2 * st["captures"]
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    mine = Counter(e[0] for e in stats.events)
    spans = [e for e in trace if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e["name"] in mine]
    assert Counter(e["name"] for e in spans) == mine
    tid = {}
    for name, _t0, _t1, thread in stats.events:
        if mine[name] == 1:
            t, = [e["tid"] for e in spans if e["name"] == name]
            tid.setdefault(thread, set()).add(t)
    rows = [t for ts in tid.values() for t in ts]
    assert len(rows) == len(set(rows)), tid     # no row holds two threads
    for tag in ("0,0", "0,1"):
        row = {n: t for n, t in ((e["name"], e["tid"]) for e in spans)
               if n.endswith(f"[{tag}]")}
        assert row["drain_wait[" + tag + "]"] == row["walk[" + tag + "]"] \
            == row["parse[" + tag + "]"] != row["fetch_wait[" + tag + "]"]
        assert f"codec_tables[{tag}]" in row and f"aux_wait[{tag}]" in row
    assert any("transport_prep_kernel" in e.get("name", "") for e in trace
               if e.get("cat") == "kernel")
