#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hydrium_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from hydrium_tpu_torch/csrc;
3. each kernel against its plain torch twin on the card, at the shapes
   the encode paths give it: transport prep (all six outputs of the
   stage) and chunk pack at one 2048x2048 LF group, one stacked tiled
   chunk and one edge tile, exactly equal, and transport prep also at a
   row count that HS does not divide and with one valid token >= 64;
   chunk pack as the pair of a dispatch (tokens with fast or with wide
   residues in one launch of pack_chunk_streams), each stream alone
   through pack_chunks, and the pair with a chunk past ow*32 bits, an
   all-zero chunk and an exactly full chunk in each stream;
   the fused front's two epilogues at one LF group (G = 64), one
   stacked tiled chunk (G = 16, u8 sRGB and f32 linear), two edge
   tiles (G = 1, true extent inside a smaller upload) and, on 16-bit
   samples of the 7680x4320 image of phase 11, its LF groups: a whole
   one (G = 64), the right column (2048x1536, G = 48), the bottom row
   (224x2048 uploaded into a 256-row buffer, G = 8) and the corner
   (224x1536, G = 6): q/dc within a
   flip bound of its plain twin; the tokens epilogue exactly equal to
   the tokenizer run on the q/dc epilogue's q, and its rows that differ
   from its own plain twin within the flip bound; and, at the edge
   tile's shape, f32 samples that saturate q, where the tokens epilogue
   must equal the tokenizer on q with 16-bit tokens (>= 2^15) present.
   For each case: the kernel's device time (torch.profiler, median of
   20), the time of one call between CUDA events with its host work
   (median of 20), the plain twin's, and the bound (bytes over 3.35
   TB/s or float32 operations, counted once from the kernel's SASS,
   over 67 TFLOP/s, whichever is larger; a chunk-pack pair's bytes are
   both streams' summed); then the CUDA graphs (ops/graphs.py) at every
   dispatch shape of phases 4 and 5 (the four LF groups of the one-frame
   encode with each front, the tiled stacked chunk and edge tile with
   the fused front), with narrow and with wide residues: the packed
   pipeline eagerly, once under torch.cuda.set_sync_debug_mode("error"),
   then four times through the graph cache with two sets of pixels,
   presets and code tables in turn (eager, captured and replayed,
   replayed, replayed), payload words equal; each call raises the
   counters by one dispatch's launches.  Per key the eager and the graph
   call, the capture's seconds and reserved MiB.  Then the cache is
   emptied, so that phases 4 and on start as a process does (a key's
   first dispatch eager, its second captured).  After phase 5, every
   graph the cache keeps has a key checked here;
4. one-frame mode: hydrium_tpu_torch.encode_image on a 3840x2160 u8
   image (noise + sinusoid, from a seed), one frame of four LF groups.
   Checks: all four LF groups packed, no fallback, each kernel launched
   exactly as often as the dispatches need, the JPEG XL signature, a
   byte-identical second encode, the same with the fused front (the
   tokens epilogue once per dispatch, the q/dc epilogue never; its
   launches held to a torch.profiler trace, as phase 5's), the
   card's front integers against the port's CPU front on one 2048^2 LF
   group (flip rate <= 1e-4), and, where libjxl loads, decode PSNR;
5. tiled mode: the same image in 256^2 tiles, sent one row at a time
   through Encoder.send_tile_batch with the fused front (the main
   path), under torch.profiler.  Checks: every stacked chunk and edge
   tile packed, no fallback, each kernel launched exactly as often as
   the dispatches need, by the wrappers' counts and by the kernels the
   trace saw on the device, which must be equal (a replay adds the
   launches of its graph to the counts without running the wrappers;
   the trace sees what it launched; a trace that lost device events is
   taken again, up to three times), the signature, a
   byte-identical second encode, decode PSNR where libjxl loads; also
   the warm time and launches with the unfused front.  The sha256 of
   the one-frame (both fronts) and tiled 4K files is printed, so two
   commits' files can be compared;
6. the command line on the card: the image written as a PNG
   (hydrium_tpu_torch/scale.py's writer) and a 1024x768 f32 PFM, then
   hydrium_tpu_torch.cli.main one-frame on the PNG (default front),
   --tile-size=0 on the PNG and one-frame --linear on the PFM (both with
   HYDRIUM_PALLAS=1, the fused front), on the default device.  Checks:
   exit 0, the signature, bytes equal to encode_image on the same array
   on the card, every dispatch packed, each kernel launched as often as
   the dispatches need, decode PSNR where libjxl loads;
7. overlap and the dispatch-preparation pool: the one-frame and the
   tiled encode (fused front) with HYDRIUM_INFLIGHT=0 (each LF group or
   unit drained before the next is dispatched) and 3 (the default),
   each with the stats' timeline on.  Checks: each file's sha256 equals
   phase 4's (one-frame, fused) or phase 5's (tiled); every unit's
   dispatch[tag] event ran on a "hyd-prep" worker.  Printed with the
   card's name and power limit: the warm walls, the median wall of one
   send_tile (send_tile_batch) call, the stages dispatch (the calling
   thread's share), prepare (the workers' upload and enqueue, summed
   over threads) and fetch_wait (the calling thread's blocked time),
   and every stage; then BufferedEncoder with a 1 MiB caller buffer
   over the one-frame encode: the same bytes;
8. multi-device and multi-process: encode_image_sharded of the 4K image
   over ["cuda:0"] and ["cuda:0", "cuda:0"], unfused and fused, each
   equal to encode_image's bytes with the same front; two processes over
   gloo on the one card (this script with --multihost-child), each
   running encode_image_multihost on its half of the presets of the 4K
   image (fused front): process 0's bytes equal encode_image's (phase
   11 runs the frame of over 2^28 pixels); and dryrun_multichip(8) over
   eight entries of the card
   inside device_trace, whose trace must hold the kernels: symbols
   within 1e-4 of the same dry run on the CPU in this process.  Each
   path's walls, dispatches and kernel launches (the children's summed)
   are printed with the card's name and power limit;
9. the conformance profile (the numpy plane, on the host): a 1000x700
   u8 image made with integer arithmetic from a seed
   (conformance_image) encoded with encode_image(...,
   profile="conformance") one-frame, tiled with shift 0, as u16
   (257 * u8) and as f32 with linear_light; each file's sha256 must
   equal the digest pinned in CONFORMANCE_SHA256, which a tier-1 test
   (tests/test_torch_conformance.py) derives from hydrium_tpu's
   backend="numpy" on the same inputs.  Then hydrium_tpu_torch.cli.main
   with --profile conformance on the image written as a PNG and with
   --backend numpy --linear on the f32 image written as a PFM: each
   file equal to the in-process one.  No device use: every kernel
   counter reads 0 across the phase and torch.cuda.memory_allocated()
   is unchanged.  The phase's host walls are printed with the card's
   name and power limit;
10. the bench (hydrium_tpu_torch/bench.py), in this process: its device
   plane on one 2048^2 LF group (20 calls a variant: eager torch and
   fused, unpacked, and torch and fused replayed from their graphs) and
   its end-to-end rows at full 4K (3 encodes a row; smooth, noisy,
   tiled, tiled with the fused front, photo).  Checks: every figure
   above 0; the fused variant and its graph launch transport_prep,
   chunk_pack and frontend_tokens once per call; the noisy one-frame
   row's file has phase 4's sha256 and the tiled-fused row's phase 5's.
   Its JSON line, and the device plane's eager and graph calls, are
   printed with the card's name and power limit;
11. the scale configurations (hydrium_tpu_torch/scale.py, BASELINE
   configs 4 and 5): config4, the 7680x4320 u16 image through
   Encoder.send_tile per LF group, cold then warm, with the default and
   with the fused front (12 LF groups packed, none fallen back, each
   kernel launched once a dispatch in the warm pass, the codestream
   signature, both passes the same bytes); the image's bottom 224x7680
   strip on the card with the front's integers taken from the port's
   CPU front (and so the eager pipeline on the card: a host front
   cannot be captured), equal byte for byte to the CPU's file, and the
   card's
   front against the CPU front on that strip within the flip bound;
   config5_cli and config5_multi at 16384 wide x 16385 tall (one row
   over 2^28 pixels, so the level-10 container comes on by itself):
   SyntheticImage written as a PNG, the CLI on it in a child process,
   and two processes over gloo on the one card, each synthesizing its
   own LF groups.  Checks: both files start with the level-10 prefix,
   they are equal, every LF group packed and each kernel launched as
   often as the dispatches need, and the RSS growth of the CLI and of
   each process (peak RSS less the resident size after the card is up
   and one small encode has run) at most half the frame's raw bytes.
   Every wall is printed with the card's name and power limit, with each
   process's device memory reserved at its peak and what its live CUDA
   graphs hold of it, then the script's whole wall.
Each encode path's launch counts are zeroed just before it and read
just after it.  The kernels line's "launches" is what phase 5's trace
saw ("launches_counted": the wrappers' count, equal to it).  A dispatch
is a packed LF group, stacked chunk or edge tile, a wide retry, or the
cold-start bootstrap of the transport codec (lfg_packed + wide_retries
+ codec_bootstraps); the codec's warm state goes to a temporary
directory, so the first encode starts cold.

Prints one JSON line of kernel results, then as the last line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --multihost-child ADDR RANK OUT

is one process of phase 8's two-process encode of the 4K image with the
fused front (process 0 writes OUT); it prints one JSON line.
"""

import ctypes.util
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

# flip-rate bound of the card's front vs the CPU front, and of the
# frontend kernel vs its plain twin on the card (float32 sums in another
# order, FMA contraction and cbrtf against pow move a few truncations per
# million); a flip moves q by at most 2 (across the dead zone), dc by 1
FRONT_FLIP_TOL = 1e-4
TILE = 256


def _time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` calls of fn, each between two CUDA events: the
    time of one call with its host work (argument checks, allocation,
    the ctypes call) as the device sees it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Median duration of the device events named `kernel` over `reps`
    calls of fn, from torch.profiler: the kernel alone, without its
    launch or any host code.  A trace on the card now and then loses
    some device events; one that kept fewer than half is taken again,
    up to five times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.name]
        if len(durs) != reps:
            print(f"profiler trace {attempt + 1} saw {len(durs)} launches "
                  f"of {kernel}, want {reps}", flush=True)
        if 2 * len(durs) >= reps:
            return statistics.median(durs) / 1e3
    raise AssertionError(f"profiler lost most launches of {kernel} in "
                         "five traces")


def _bound_ms(n_bytes: int, n_ops: int = 0) -> tuple:
    """Least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the non-tensor-core
    float32 peak (PEAK_* below).  Returns (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _transport_case(rng, dev, N: int, max_tok: int = 64):
    """Transport stage inputs from a seed; tokens below max_tok."""
    import torch

    tokens = rng.integers(0, max_tok, (N, 64)).astype(np.int16)
    clusters = rng.integers(0, 27, (N, 64)).astype(np.uint8)
    valid_len = rng.integers(0, 65, N).astype(np.int32)
    valid_len[:6] = [0, 1, 64, 64, 0, 33]
    rbits = rng.integers(0, 31, (N, 64)).astype(np.uint8)
    res = (rng.integers(0, 1 << 31, (N, 64), dtype=np.int64)
           & ((1 << rbits.astype(np.int64)) - 1)).astype(np.int32)
    # transport code tables: lengths 1..12, codewords below 2^length
    lens = rng.integers(1, 13, 10 * 64).astype(np.int32)
    codes = (rng.integers(0, 1 << 12, 10 * 64) & ((1 << lens) - 1)).astype(
        np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(tokens), t(clusters), t(valid_len), t(res), t(rbits),
            t(lens), t(codes))


def _pack_case(rng, dev, R: int, ch: int, cap: int, p: float,
               overflow_rows: int = 0):
    import torch

    F = R * ch
    widths = np.minimum(rng.geometric(p, F), cap).astype(np.int64)
    widths[rng.random(F) < 0.3] = 0
    widths[:ch * overflow_rows] = cap
    vals = (rng.integers(0, 1 << 31, F, dtype=np.int64) * 2
            + rng.integers(0, 2, F)) & ((1 << widths) - 1)
    vals = np.where(vals >= 1 << 31, vals - (1 << 32), vals)
    return (torch.as_tensor(vals.astype(np.int32), device=dev),
            torch.as_tensor(widths.astype(np.int32), device=dev))


# the shapes the encode paths give transport prep and chunk pack, in
# groups of 3072 [64]-slot rows: one 2048^2 LF group (one-frame mode),
# one stacked chunk of 16 tiles and one edge tile (tiled mode)
KERNEL_SHAPES = {"lfg": 64, "chunk": 16, "edge": 1}
# the card's rates for the bounds (H100 SXM data sheet): HBM3 bytes/s
# and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def _transport_bytes(N: int) -> int:
    """Bytes transport_prep must move for N rows: per slot a u16 token,
    u8 cluster, u32 residue and u8 width read and four u32 words
    written; valid_len, the two code tables read; histogram and tok_ok
    written."""
    return N * 64 * (8 + 16) + N * 4 + 2 * 640 * 4 + 576 * 4 + 1


def _check_transport(name, args, hs, timed=True):
    """transport_prep vs its plain twin on the card: all six outputs
    exactly equal.  Returns the case's record."""
    import torch

    from hydrium_tpu_torch.ops.transport import (transport_prep,
                                                 transport_prep_plain)

    N = args[2].shape[0]
    got = transport_prep(*args, tok_classes=9, hs=hs)
    want = transport_prep_plain(*args, tok_classes=9, hs=hs)
    torch.cuda.synchronize()
    names = ("t_flat", "t_bits", "hist", "r_flat", "r_bits", "tok_ok")
    for g, w, n in zip(got, want, names):
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = int((g != w).sum().item())
            raise AssertionError(f"transport_prep {name} {n}: {bad} "
                                 "mismatches")
    err = max(int((g.long() - w.long()).abs().max()) for g, w in
              zip(got, want))
    rec = {"N": N, "hs": hs, "tok_ok": bool(got[5]), "max_abs_err": err}
    if timed:
        run = lambda: transport_prep(*args, tok_classes=9, hs=hs)
        rec["ms"] = _time_ms(run)
        rec["device_ms"] = _device_ms(run, "transport_prep_kernel")
        rec["plain_ms"] = _time_ms(lambda: transport_prep_plain(
            *args, tok_classes=9, hs=hs))
        rec["bound_ms"], rec["bound_by"] = _bound_ms(_transport_bytes(N))
        print(f"transport_prep {name} N={N} hs={hs}: six outputs equal "
              f"(tok_ok {rec['tok_ok']}); device {rec['device_ms']:.4f} ms,"
              f" per call host included {rec['ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['device_ms']:.0%}), plain "
              f"{rec['plain_ms']:.4f} ms", flush=True)
    else:
        print(f"transport_prep {name} N={N} hs={hs}: six outputs equal "
              f"(tok_ok {rec['tok_ok']})", flush=True)
    return rec


def _pack_edge_case(rng, dev, R: int, ch: int, ow: int, cap: int, p: float):
    """R chunks drawn as _pack_case draws them, but chunk 0 past ow*32
    bits (every field at over 32*ow/ch bits), chunk 1 of zero widths only
    and chunk 2 of exactly ow*32 bits."""
    import torch

    widths = np.minimum(rng.geometric(p, (R, ch)), cap)
    widths[rng.random((R, ch)) < 0.3] = 0
    widths[0] = 32 * ow // ch + 1
    widths[1] = 0
    exact = np.full(ch, 32 * ow // ch)
    exact[:32 * ow % ch] += 1
    widths[2] = rng.permutation(exact)
    widths = widths.reshape(-1).astype(np.int64)
    vals = rng.integers(0, 1 << 32, R * ch, dtype=np.int64) & (
        (1 << widths) - 1)
    return (torch.as_tensor(vals.astype(np.uint32).view(np.int32),
                            device=dev),
            torch.as_tensor(widths.astype(np.int32), device=dev), ch, ow)


def _pack_bytes(stream) -> int:
    """Bytes chunk pack must move for one stream: 8 per field read, the
    [R, ow] rows and R chunk_bits written."""
    values, _nbits, ch, ow = stream
    R = values.shape[0] // ch
    return R * ch * 8 + R * ow * 4 + R * 4


def _check_pack(name, streams, timed=True):
    """Chunk pack on the card against its plain twin per stream, exactly
    equal: two streams through pack_chunk_streams (one launch), one
    through pack_chunks.  Returns the case's record."""
    import torch

    from hydrium_tpu_torch.ops.bitpack import (pack_chunk_streams,
                                               pack_chunks,
                                               pack_chunks_plain)

    if len(streams) == 2:
        run = lambda: pack_chunk_streams(*streams)
    else:
        run = lambda: (pack_chunks(*streams[0]),)
    plain = lambda: tuple(pack_chunks_plain(*st) for st in streams)
    got, want = run(), plain()
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        for a, b, n in zip(g, w, ("chunks", "chunk_bits")):
            if a.shape != b.shape or not torch.equal(a, b):
                bad = int((a != b).sum().item())
                raise AssertionError(f"chunk_pack {name} stream {k} {n}: "
                                     f"{bad} mismatches")
    rec = {"R": [st[0].shape[0] // st[2] for st in streams],
           "ch": [st[2] for st in streams], "ow": [st[3] for st in streams],
           "max_abs_err": max(int((a.long() - b.long()).abs().max())
                              for g, w in zip(got, want)
                              for a, b in zip(g, w))}
    if not timed:
        print(f"chunk_pack {name} R={rec['R']} ow={rec['ow']}: equal",
              flush=True)
        return rec
    rec["ms"] = _time_ms(run)
    rec["device_ms"] = _device_ms(run, "chunk_pack_streams_kernel")
    rec["plain_ms"] = _time_ms(plain)
    rec["bound_ms"], rec["bound_by"] = _bound_ms(
        sum(_pack_bytes(st) for st in streams))
    print(f"chunk_pack {name} R={rec['R']} ow={rec['ow']}: equal; device "
          f"{rec['device_ms']:.4f} ms, per call host included "
          f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
          f"({rec['bound_ms'] / rec['device_ms']:.0%}), plain "
          f"{rec['plain_ms']:.4f} ms", flush=True)
    return rec


def check_kernels(dev):
    """Phase 3: transport prep and chunk pack vs their plain twins, exactly
    equal, at every main-path shape, and transport prep also where HS
    does not divide N and with one valid token >= 64; chunk pack as the
    pair of a dispatch (tokens with fast or wide residues, one launch),
    each stream alone, and the pair with an overflowing, an all-zero and
    an exactly full chunk in each stream.  The top-level times are the
    LF group's (one-frame mode); by_case holds all."""
    from hydrium_tpu_torch.ops import constants as C

    HS = C.HIST_SAMPLE_STRIDE
    rng = np.random.default_rng(2160)
    tp, pk = {}, {}
    res_geometries = {"fast": (C.RES_OW_FAST, C.RES_CAP_FAST, 0.4, 0),
                      "wide": (C.RES_OW_WIDE, C.RES_CAP_WIDE, 0.2, 2)}
    for shape, G in KERNEL_SHAPES.items():
        N = G * 3072
        tp[shape] = _check_transport(shape, _transport_case(rng, dev, N), HS)

        M = N * 64
        tok = _pack_case(rng, dev, M // C.TOK_CHUNK, C.TOK_CHUNK,
                         C.TOK_MAX_LEN, 0.35) + (C.TOK_CHUNK, C.TOK_OW)
        res = {k: _pack_case(rng, dev, M // C.RES_CHUNK, C.RES_CHUNK, cap, p,
                             ovf) + (C.RES_CHUNK, ow)
               for k, (ow, cap, p, ovf) in res_geometries.items()}
        for k in res:
            pk[f"{shape}/pair_{k}"] = _check_pack(f"{shape} pair tokens + "
                                                  f"residues {k}",
                                                  (tok, res[k]))
        pk[f"{shape}/tokens"] = _check_pack(f"{shape} tokens alone", (tok,))
        pk[f"{shape}/residues_fast"] = _check_pack(
            f"{shape} residues fast alone", (res["fast"],))
    # overflow, all-zero and exactly full chunks, at the edge tile's
    # chunk counts
    M = KERNEL_SHAPES["edge"] * 3072 * 64
    for k, (ow, cap, p, _ovf) in res_geometries.items():
        pk[f"edge_cases_{k}"] = _check_pack(
            f"edge cases, residues {k}",
            (_pack_edge_case(rng, dev, M // C.TOK_CHUNK, C.TOK_CHUNK,
                             C.TOK_OW, C.TOK_MAX_LEN, 0.35),
             _pack_edge_case(rng, dev, M // C.RES_CHUNK, C.RES_CHUNK, ow,
                             cap, p)), timed=False)
    # the stage's two edge cases: every row sampled (hs 1) with all
    # tokens < 64, and one valid token >= 64 among tokens < 64
    odd = _transport_case(rng, dev, 3073)
    tp["rows_not_multiple_of_hs"] = _check_transport(
        "rows_not_multiple_of_hs", odd, 1, timed=False)
    assert tp["rows_not_multiple_of_hs"]["tok_ok"]
    tok64 = _transport_case(rng, dev, 3072)
    tok64[0][2, 5] = 64                      # row 2 has valid_len 64
    tp["token_ge_64"] = _check_transport("token_ge_64", tok64, HS,
                                         timed=False)
    assert not tp["token_ge_64"]["tok_ok"]
    top, pair = tp["lfg"], pk["lfg/pair_fast"]
    return [{"name": "transport_prep", "route": "cuda",
             "source": "hydrium_tpu_torch/csrc/transport_prep.cu",
             "replaces": "hydrium_tpu/ops/pallas/prep.py:221",
             "max_abs_err": max(c["max_abs_err"] for c in tp.values()),
             "ms": top["ms"], "device_ms": top["device_ms"],
             "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
             "bound_by": top["bound_by"], "library_ms": None,
             "shape": "LF group, N = 196608", "by_case": tp},
            {"name": "chunk_pack", "route": "cuda",
             "source": "hydrium_tpu_torch/csrc/chunk_pack.cu",
             "replaces": "hydrium_tpu/ops/pallas/bitpack.py:203",
             "max_abs_err": max(c["max_abs_err"] for c in pk.values()),
             "ms": pair["ms"], "device_ms": pair["device_ms"],
             "plain_ms": pair["plain_ms"], "bound_ms": pair["bound_ms"],
             "bound_by": pair["bound_by"], "library_ms": None,
             "shape": "LF group, tokens + residues fast in one launch",
             "by_case": pk}]


# float32 operations per pixel of the frontend kernel's prologue (sample
# scaling or the u8 table, XYB with three cube roots, the DCT, the
# quantization), per sample type: the float32 instructions of its SASS
# (an FFMA counts two) over the 8 pixels a thread takes per strip, as
# `python3 profile_front.py --sass` counts them on the built library
# (sm_90a, -O3): 1487, 1682 and 1658 over 8.  A static count, so it also
# holds the unaligned load path; the epilogues do integer work only.
FRONT_F32_OPS_PER_PIXEL = {"uint8": 1487 / 8, "uint16": 1682 / 8,
                           "float32": 1658 / 8}


def _frontend_bounds(px, G: int, sample_kind: str) -> dict:
    """Bounds of the two epilogues over one buffer of G groups.  Bytes:
    the upload read once; q (i32 [N, 64]) or the five streams (8 bytes
    a slot and valid_len) written once, with the DC grid; the tokens
    epilogue also reads the presets.  Operations: the prologue's float32
    operations over every pixel of the buffer."""
    N = G * 3072
    px_bytes = px.numel() * px.element_size()
    dc_bytes = 4 * G * 1024 * 3
    ops = FRONT_F32_OPS_PER_PIXEL[sample_kind] * G * 65536
    return {"q": _bound_ms(px_bytes + 4 * N * 64 + dc_bytes, ops),
            "tokens": _bound_ms(px_bytes + 8 * N * 64 + 4 * N + dc_bytes
                                + 4 * G, ops)}


STREAMS = ("tokens", "clusters", "residues", "residue_bits", "valid_len")


def _tokens_equal(name, toks, want, lf) -> int:
    """The tokens epilogue's five streams and lf_q against the tokenizer
    run on the q/dc epilogue's q (want) and that epilogue's lf: every
    value equal.  Returns the largest difference of the stored values
    (so 0)."""
    import torch

    if not torch.equal(toks["lf_q"], lf):
        raise AssertionError(f"frontend_tokens {name} lf_q differs from the "
                             "q/dc epilogue's")
    for k in STREAMS:
        if toks[k].dtype != want[k].dtype or not torch.equal(toks[k],
                                                             want[k]):
            raise AssertionError(f"frontend_tokens {name} {k}: "
                                 f"{int((toks[k] != want[k]).sum())} values "
                                 "differ from the tokenizer on q")
    return max(int((toks[k].long() - want[k].long()).abs().max().item())
               for k in STREAMS)


def _frontend_saturating_case(px, h, w, buf) -> dict:
    """The tokens epilogue on f32 linear samples that make q saturate
    (INT32_MAX) and the tokenizer see values >= 2^31: exactly equal to
    the tokenizer run on the q/dc epilogue's q, with 16-bit tokens
    (>= 2^15, no residue) present.  Not held against the plain twin:
    cube roots of +-1e30 summed in another order move q by more than a
    flip."""
    import torch

    from hydrium_tpu_torch.ops.front import tokenize_lfg
    from hydrium_tpu_torch.ops.frontend import (_tables, frontend_lfg,
                                                frontend_tokens)

    kw = dict(buf_h=buf[0], buf_w=buf[1], linear_light=True,
              sample_kind="float32")
    G = (buf[0] >> 8) * (buf[1] >> 8)
    presets = torch.arange(G, dtype=torch.int32, device=px.device) % 3
    q, lf = frontend_lfg(px, h, w, **kw)
    toks = frontend_tokens(px, h, w, presets, clusters_per_preset=9, **kw)
    want = tokenize_lfg(q, presets, h, w, buf_h=buf[0], buf_w=buf[1],
                        clusters_per_preset=9, tabs=_tables(px.device))
    torch.cuda.synchronize()
    err = _tokens_equal("saturating", toks, want, lf)
    n_max = int((q == torch.iinfo(torch.int32).max).sum().item())
    n_wide = int((toks["tokens"] < 0).sum().item())
    assert n_max > 0 and n_wide > 0, (n_max, n_wide)
    print(f"frontend tokens edge_f32_saturating G={G}: equal to the "
          f"tokenizer on q; {n_max} q at INT32_MAX, {n_wide} tokens >= 2^15",
          flush=True)
    return {"max_abs_err": err, "q_at_int32_max": n_max,
            "tokens_ge_2_15": n_wide}


def _frontend_case(name, px, h, w, buf, linear, kind):
    """Both epilogues of the frontend kernel on one buffer: q/dc against
    its plain twin within the flip bound; tokens exactly equal to the
    tokenizer (front.tokenize_lfg) run on the q/dc epilogue's q, and by
    rows against its own plain twin.  Returns the two records."""
    import torch

    from hydrium_tpu_torch.ops.front import tokenize_lfg
    from hydrium_tpu_torch.ops.frontend import (_tables, frontend_lfg,
                                                frontend_lfg_plain,
                                                frontend_tokens,
                                                frontend_tokens_plain)

    kw = dict(buf_h=buf[0], buf_w=buf[1], linear_light=linear,
              sample_kind=kind)
    G = (buf[0] >> 8) * (buf[1] >> 8)
    presets = torch.arange(G, dtype=torch.int32, device=px.device) % 3
    tkw = dict(kw, clusters_per_preset=9)
    q, lf = frontend_lfg(px, h, w, **kw)
    pq, plf = frontend_lfg_plain(px, h, w, **kw)
    toks = frontend_tokens(px, h, w, presets, **tkw)
    want = tokenize_lfg(q, presets, h, w, buf_h=buf[0], buf_w=buf[1],
                        clusters_per_preset=9, tabs=_tables(px.device))
    plain = frontend_tokens_plain(px, h, w, presets, **tkw)
    torch.cuda.synchronize()
    flips = int((q != pq).sum().item()) + int((lf != plf).sum().item())
    total = q.numel() + lf.numel()
    dq = int((q - pq).abs().max().item())
    dlf = int((lf - plf).abs().max().item())
    assert flips <= FRONT_FLIP_TOL * total, (name, flips, total)
    assert dq <= 2 and dlf <= 1, (name, dq, dlf)
    tok_err = _tokens_equal(name, toks, want, lf)
    rows = torch.zeros_like(toks["valid_len"], dtype=torch.bool)
    for k in STREAMS:
        d = toks[k] != plain[k]
        rows |= d if d.dim() == 1 else d.any(dim=1)
    rows = int(rows.sum().item())
    assert rows <= FRONT_FLIP_TOL * q.numel(), (name, rows)
    bounds = _frontend_bounds(px, G, kind)
    recs = {}
    for ep, run, plain_run in (
            ("q", lambda: frontend_lfg(px, h, w, **kw),
             lambda: frontend_lfg_plain(px, h, w, **kw)),
            ("tokens", lambda: frontend_tokens(px, h, w, presets, **tkw),
             lambda: frontend_tokens_plain(px, h, w, presets, **tkw))):
        rec = recs[ep] = {
            "ms": _time_ms(run), "device_ms": _device_ms(run,
                                                         "frontend_kernel"),
            "plain_ms": _time_ms(plain_run)}
        rec["bound_ms"], rec["bound_by"] = bounds[ep]
        print(f"frontend {ep} {name} G={G}: device {rec['device_ms']:.4f} "
              f"ms, per call host included {rec['ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
              f"({rec['bound_ms'] / rec['device_ms']:.0%}), plain "
              f"{rec['plain_ms']:.4f} ms", flush=True)
    recs["q"].update(flips=flips, values=total, max_abs_err=max(dq, dlf))
    recs["tokens"].update(rows_vs_plain=rows, rows=q.shape[0],
                          max_abs_err=tok_err)
    print(f"frontend {name} G={G}: q/dc {flips} flips of {total} "
          f"({flips / total:.2e}, bound {FRONT_FLIP_TOL:g}), max |dq| {dq}, "
          f"max |ddc| {dlf}; tokens equal the tokenizer on q, {rows} of "
          f"{q.shape[0]} rows differ from the plain twin", flush=True)
    return recs


def check_frontend(img: np.ndarray, img16: np.ndarray, dev):
    """Phase 3, fused front, both epilogues: one 2048^2 LF group
    (G = 64), one stacked chunk of 16 tiles (G = 16, u8 sRGB and f32
    linear light), edge tiles (G = 1) whose true extent is smaller
    than the upload, which is smaller than the buffer: the kernel's own
    pad and mask; and the LF groups of img16, the 7680x4320 u16 image
    of phase 11: (0, 0), the right column, the bottom row (224 rows
    uploaded into a 256-row buffer) and the corner."""
    import torch

    lfg = torch.as_tensor(np.ascontiguousarray(img[:2048, :2048]),
                          device=dev)
    tiles = [img[ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE]
             for ty in range(2) for tx in range(img.shape[1] // TILE)][:16]
    stack = np.concatenate(tiles, axis=0)                 # 4096 x 256
    stack_f32 = ((stack / np.float32(255.0)) ** 2.2).astype(np.float32)
    # the tiled path's edge tile: true 112x256 in a zero-padded 128x256
    # upload (rows bucketed to 32) of a 256^2 buffer
    edge = np.zeros((128, TILE, 3), np.uint8)
    edge[:112] = img[2048:2160, :TILE]
    # true 112x200 in a 128x224 upload, with nonzero samples outside the
    # true extent that the kernel must mask
    narrow = np.full((128, 224, 3), 255, np.uint8)
    narrow[:112, :200] = img[2048:2160, :200]
    t = lambda a: torch.as_tensor(a, device=dev)
    # the edge tile's shape in f32 linear light, a fifth of the samples
    # +-1e30 or +-1e25
    rng = np.random.default_rng(112)
    huge = np.zeros((128, TILE, 3), np.float32)
    huge[:112] = rng.random((112, TILE, 3))
    big = np.zeros(huge.shape, bool)
    big[:112] = rng.random((112, TILE, 3)) < 0.2
    huge[big] = rng.choice(np.float32([1e30, -1e30, 1e25, -1e25]),
                           int(big.sum()))
    saturating = _frontend_saturating_case(t(huge), 112, TILE, (TILE, TILE))
    u16 = {}
    for name, y, x, h, w in (("lfg_u16", 0, 0, 2048, 2048),
                             ("right_u16", 0, 6144, 2048, 1536),
                             ("bottom_u16", 4096, 0, 224, 2048),
                             ("corner_u16", 4096, 6144, 224, 1536)):
        px = t(np.ascontiguousarray(img16[y:y + h, x:x + w]))
        u16[name] = (px, h, w, (-(-h // TILE) * TILE, w), False, "uint16")
    cases = {name: _frontend_case(name, *args) for name, args in (
        ("edge_u8", (t(edge), 112, TILE, (TILE, TILE), False, "uint8")),
        ("edge_narrow_u8", (t(narrow), 112, 200, (TILE, TILE), False,
                            "uint8")),
        ("lfg_u8", (lfg, 2048, 2048, (2048, 2048), False, "uint8")),
        ("chunk_u8", (t(stack), 4096, TILE, (4096, TILE), False, "uint8")),
        ("chunk_f32_linear", (t(stack_f32), 4096, TILE, (4096, TILE), True,
                              "float32")), *u16.items())}
    shape = ("lfg_u8: 2048x2048 (G=64); chunk_u8: 4096x256 (G=16); "
             "chunk_f32_linear: 4096x256; edge_u8: 112x256 in 128x256 "
             "(G=1); edge_narrow_u8: 112x200 in 128x224 (G=1); lfg_u16: "
             "2048x2048 (G=64); right_u16: 2048x1536 (G=48); bottom_u16: "
             "224x2048 in a 256x2048 buffer (G=8); corner_u16: 224x1536 "
             "in a 256x1536 buffer (G=6)")
    out = []
    for name, ep in (("frontend_groups", "q"), ("frontend_tokens", "tokens")):
        by_case = {k: c[ep] for k, c in cases.items()}
        top = by_case["lfg_u8"]
        rec = {"name": name, "route": "cuda",
               "source": "hydrium_tpu_torch/csrc/frontend.cu",
               "replaces": "hydrium_tpu/ops/pallas/frontend.py:132",
               "epilogue": ep,
               "max_abs_err": max(c["max_abs_err"] for c in by_case.values()),
               "ms": top["ms"], "device_ms": top["device_ms"],
               "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
               "bound_by": top["bound_by"], "library_ms": None,
               "f32_ops_per_pixel": FRONT_F32_OPS_PER_PIXEL,
               "by_case": by_case, "shape": shape}
        if ep == "q":
            rec["flips"] = sum(c["flips"] for c in by_case.values())
            rec["values"] = sum(c["values"] for c in by_case.values())
        else:
            rec["rows_vs_plain"] = sum(c["rows_vs_plain"]
                                       for c in by_case.values())
            rec["saturating"] = saturating
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     saturating["max_abs_err"])
        out.append(rec)
    return out


def encode_tiled(img: np.ndarray, fused: bool, stats,
                 walls: Optional[list] = None) -> bytes:
    """256^2 tiles sent one row at a time through send_tile_batch (as
    bench.py sends tiled mode); the wall of each send_tile_batch call
    goes to `walls` when one is given."""
    import torch

    import hydrium_tpu_torch as H

    h, w = img.shape[:2]
    meta = H.ImageMetadata(width=w, height=h, tile_size_shift_x=0,
                           tile_size_shift_y=0)
    enc = H.Encoder(meta, device="cuda", fused_front=fused)
    enc.stats = stats
    out = bytearray()
    for ty in range((h + TILE - 1) // TILE):
        entries = [(img[ty * TILE:(ty + 1) * TILE,
                        tx * TILE:(tx + 1) * TILE], tx, ty)
                   for tx in range((w + TILE - 1) // TILE)]
        t0 = time.perf_counter()
        enc.send_tile_batch(entries, sample_fmt=H.SampleFormat.UINT8)
        if walls is not None:
            walls.append(time.perf_counter() - t0)
        out.extend(enc.take_output())
    torch.cuda.synchronize()
    return bytes(out)


def write_pfm(path: str, img: np.ndarray) -> None:
    """A little-endian color PFM of float32 img (rows bottom-up)."""
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def n_dispatches(counters) -> int:
    """Dispatches an encode made: packed units, wide retries, and the
    cold-start bootstrap."""
    return (counters.get("lfg_packed", 0) + counters.get("wide_retries", 0)
            + counters.get("codec_bootstraps", 0))


def run_cli(argv, fused: bool):
    """hydrium_tpu_torch.cli.main(argv) on the default device, with
    HYDRIUM_PALLAS set as `fused` says; returns (exit code, the
    Encoder's counters, the calling thread's stage seconds)."""
    from hydrium_tpu_torch import cli
    from hydrium_tpu_torch.scale import made_encoders

    old = os.environ.get("HYDRIUM_PALLAS")
    os.environ["HYDRIUM_PALLAS"] = "1" if fused else "0"
    try:
        with made_encoders() as made:
            rc = cli.main(argv)
    finally:
        if old is None:
            del os.environ["HYDRIUM_PALLAS"]
        else:
            os.environ["HYDRIUM_PALLAS"] = old
    enc, = made
    assert enc.device.type == "cuda", enc.device
    assert enc.fused_front == fused
    return rc, dict(enc.stats.counters), dict(enc.stats.stage_seconds)


def encode_one_frame(img: np.ndarray, fused: bool, stats,
                     walls: Optional[list] = None) -> bytes:
    """Encoder.send_tile per 2048^2 LF group, take_output after each, as
    encode_image sends them; the wall of each send_tile call goes to
    `walls` when one is given."""
    import torch

    import hydrium_tpu_torch as H

    h, w = img.shape[:2]
    enc = H.Encoder(H.ImageMetadata(width=w, height=h), device="cuda",
                    fused_front=fused)
    enc.stats = stats
    out = bytearray()
    for ty in range(-(-h // 2048)):
        for tx in range(-(-w // 2048)):
            t0 = time.perf_counter()
            enc.send_tile(img[ty * 2048:(ty + 1) * 2048,
                              tx * 2048:(tx + 1) * 2048], tx, ty,
                          sample_fmt=H.SampleFormat.UINT8)
            if walls is not None:
                walls.append(time.perf_counter() - t0)
            out.extend(enc.take_output())
    torch.cuda.synchronize()
    return bytes(out)


def timed_with_window(encode, img, inflight: int):
    """encode(img, True, stats) with HYDRIUM_INFLIGHT set to `inflight`:
    one warm-up, then one timed run with the stats' timeline on.
    Returns (bytes, wall seconds, its EncodeStats, the walls of its
    send calls)."""
    from hydrium_tpu_torch import EncodeStats

    old = os.environ.pop("HYDRIUM_INFLIGHT", None)
    os.environ["HYDRIUM_INFLIGHT"] = str(inflight)
    try:
        encode(img, True, EncodeStats())
        stats = EncodeStats()
        stats.enable_timeline()
        sends = []
        t0 = time.perf_counter()
        data = encode(img, True, stats, sends)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("HYDRIUM_INFLIGHT", None)
        if old is not None:
            os.environ["HYDRIUM_INFLIGHT"] = old
    return data, wall, stats, sends


def check_overlap(img: np.ndarray, digests: dict, data: bytes,
                  smi: str) -> dict:
    """Phase 7 (see the module docstring).  digests: phase 4's and 5's
    sha256 by file; data: phase 4's one-frame file (default front).
    Returns the phase's figures by mode and window."""
    import hydrium_tpu_torch as H

    overlap = {}
    for name, encode, digest in (
            ("one_frame", encode_one_frame, digests["one_frame_fused"]),
            ("tiled", encode_tiled, digests["tiled_fused"])):
        overlap[name] = {}
        for window in (0, 3):
            got, wall, pstats, sends = timed_with_window(encode, img, window)
            assert hashlib.sha256(got).hexdigest() == digest, (
                f"{name}: HYDRIUM_INFLIGHT={window} bytes differ from "
                "phases 4 and 5")
            # the caller's own stage "dispatch" carries the same name
            caller = threading.current_thread().name
            preps = [thread for ev, _t0, _t1, thread in pstats.events
                     if ev.startswith("dispatch[") and thread != caller]
            assert len(preps) == pstats.counters.get("lfg_packed", 0), preps
            assert all(t.startswith("hyd-prep") for t in preps), preps
            sec = pstats.stage_seconds
            run = {"wall_s": wall, "send_calls": len(sends),
                   "send_median_s": statistics.median(sends),
                   "dispatch_s": sec.get("dispatch", 0.0),
                   "prepare_s": sec.get("prepare", 0.0),
                   "fetch_wait_s": sec.get("fetch_wait", 0.0),
                   "stages_s": {k: round(v, 4) for k, v in sec.items()}}
            overlap[name][f"inflight_{window}"] = run
            print(f"overlap {name} 4K, fused front, warm, "
                  f"HYDRIUM_INFLIGHT={window}, on {smi}: wall {wall:.4f} s; "
                  f"median send call {run['send_median_s'] * 1e3:.2f} ms "
                  f"of {len(sends)}; stage dispatch (caller) "
                  f"{run['dispatch_s']:.4f} s, prepare (hyd-prep workers) "
                  f"{run['prepare_s']:.4f} s, fetch_wait "
                  f"{run['fetch_wait_s']:.4f} s; {len(preps)} dispatches "
                  f"enqueued on {sorted(set(preps))}; stages "
                  f"{run['stages_s']}; sha256 equal to phases 4 and 5",
                  flush=True)
    want = encode_one_frame(img, False, H.EncodeStats())
    assert want == data, "one-frame bytes changed within the run"
    h, w = img.shape[:2]
    be = H.BufferedEncoder(H.Encoder(H.ImageMetadata(width=w, height=h)))
    buf = bytearray(1 << 20)
    pushed = bytearray()
    swaps = 0
    be.provide_output_buffer(buf)
    for ty in range(-(-h // 2048)):
        for tx in range(-(-w // 2048)):
            st = be.send_tile(img[ty * 2048:(ty + 1) * 2048,
                                  tx * 2048:(tx + 1) * 2048], tx, ty)
            while st == H.NEED_MORE_OUTPUT:
                swaps += 1
                pushed.extend(buf[:be.release_output_buffer()])
                be.provide_output_buffer(buf)
                st = be.pump()
    pushed.extend(buf[:be.release_output_buffer()])
    assert be.finished and bytes(pushed) == data, "BufferedEncoder bytes"
    print(f"BufferedEncoder, 1 MiB buffer: {swaps} swaps, {len(pushed)} "
          f"bytes, equal to encode_image's", flush=True)
    return overlap


def make_4k(seed: int = 0) -> np.ndarray:
    """3840x2160 u8: sinusoid plus Gaussian noise (the bench's
    make_4k_noisy)."""
    from hydrium_tpu_torch.bench import make_4k_noisy

    return make_4k_noisy(seed)


def front_flips(px: np.ndarray, dev, kind: str = "uint8") -> tuple:
    """The card's front integers vs the port's CPU front on the pixels
    of one LF group (its buffer: the extent rounded up to 256)."""
    import torch

    from hydrium_tpu_torch.ops.front import FrontEnd

    h, w = px.shape[:2]
    kw = dict(buf_h=-(-h // TILE) * TILE, buf_w=-(-w // TILE) * TILE,
              linear_light=False, sample_kind=kind)
    px = np.ascontiguousarray(px)
    outs = []
    for d in (dev, torch.device("cpu")):
        fe = FrontEnd.from_tables().to(d)
        q, lf = fe(torch.as_tensor(px, device=d), h, w, **kw)
        outs.append((q.cpu(), lf.cpu()))
    (qg, lg), (qc, lc) = outs
    flips = int((qg != qc).sum().item()) + int((lg != lc).sum().item())
    return flips, qg.numel() + lg.numel()


# sha256 of phase 9's conformance files (conformance_inputs); the
# numpy plane is elementwise float32 numpy, so these hold on any machine,
# and tests/test_torch_conformance.py holds hydrium_tpu's backend="numpy"
# to them
CONFORMANCE_SHA256 = {
    "one_frame":
        "6ca0e85116f1a404c12b1899a02324f7fee0bb1930226b279e1953bbd465a1d2",
    "tiled_0":
        "eb73fc470f296b7b0dd955035e146ed5fb432008159fb3e21418cf4c4cf7ce19",
    # the u8 file: the numpy plane's input LUTs map v and 257 * v to
    # the same 16-bit linear sample
    "u16":
        "6ca0e85116f1a404c12b1899a02324f7fee0bb1930226b279e1953bbd465a1d2",
    "f32_linear":
        "150cea9565873bc98dc5b84f8e934cf3c2399e517349513e3c9042635d0aa3d4",
}


def conformance_image(width: int = 1000, height: int = 700,
                      seed: int = 0) -> np.ndarray:
    """[height, width, 3] u8: a diagonal gradient plus hashed noise in
    [0, 64), in integer arithmetic only, so that every machine makes the
    same pixels from the same seed."""
    yu = np.arange(height, dtype=np.uint32)[:, None, None]
    xu = np.arange(width, dtype=np.uint32)[None, :, None]
    cu = np.arange(3, dtype=np.uint32)[None, None, :]
    grad = (xu * np.uint32(128) // np.uint32(width)
            + yu * np.uint32(48) // np.uint32(height) + cu * np.uint32(8))
    h = (yu * np.uint32(2654435761) ^ xu * np.uint32(0x9E3779B9)
         ^ cu * np.uint32(0x85EBCA6B)
         ^ np.uint32((seed * 0x27D4EB2F + 1) & 0xFFFFFFFF))
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x2C1B3C6D)
    h ^= h >> np.uint32(12)
    return (grad + ((h >> np.uint32(8)) & np.uint32(63))).astype(np.uint8)


def conformance_inputs():
    """(name, pixels, tile_size_shift, linear_light) of phase 9's four
    encodes, each keyed as in CONFORMANCE_SHA256."""
    img = conformance_image()
    return [("one_frame", img, -1, False),
            ("tiled_0", img, 0, False),
            ("u16", img.astype(np.uint16) * np.uint16(257), -1, False),
            ("f32_linear", img.astype(np.float32) / np.float32(255), -1,
             True)]


def check_conformance(scratch: str, smi: str) -> dict:
    """Phase 9: the conformance profile's files, in process and through
    the CLI, against the pinned digests, with no device use."""
    import torch

    import hydrium_tpu_torch as H
    from hydrium_tpu_torch import cli
    from hydrium_tpu_torch.scale import write_png

    inputs = conformance_inputs()
    kernel_counts(zero=True)
    mem0 = torch.cuda.memory_allocated()
    files, walls = {}, {}
    for name, px, shift, linear in inputs:
        t0 = time.perf_counter()
        files[name] = H.encode_image(px, shift, linear_light=linear,
                                     profile="conformance")
        walls[name] = time.perf_counter() - t0
        digest = hashlib.sha256(files[name]).hexdigest()
        assert digest == CONFORMANCE_SHA256[name], (name, digest)
    png = os.path.join(scratch, "conformance.png")
    pfm = os.path.join(scratch, "conformance.pfm")
    write_png(png, inputs[0][1])
    write_pfm(pfm, inputs[3][1])
    for name, src, flags, want in (
            ("cli_png_profile", png, ["--profile", "conformance"],
             "one_frame"),
            ("cli_pfm_backend_linear", pfm, ["--backend", "numpy",
                                             "--linear"], "f32_linear")):
        out = os.path.join(scratch, name + ".jxl")
        t0 = time.perf_counter()
        rc = cli.main([src, out] + flags)
        walls[name] = time.perf_counter() - t0
        assert rc == 0, (name, rc)
        with open(out, "rb") as f:
            assert f.read() == files[want], f"{name}: bytes differ"
    launches = kernel_counts()
    assert not any(launches.values()), launches
    mem1 = torch.cuda.memory_allocated()
    assert mem1 == mem0, (mem0, mem1)
    print(f"conformance profile (numpy plane, host walls) on {smi}: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; sizes { {k: len(v) for k, v in files.items()} }, digests "
          f"pinned, CLI files equal, launches {launches}, "
          f"memory_allocated {mem0} -> {mem1}", flush=True)
    return {"host_walls_s": walls, "launches": launches,
            "bytes": {k: len(v) for k, v in files.items()}}


def graph_cases(img: np.ndarray):
    """(name, upload [ubuf_h, ubuf_w, 3], preset, LF group geometry,
    lf_seg_vb, fused) of every dispatch shape of phases 4 and 5: the four
    LF groups of the one-frame 4K encode with each front, and the tiled
    encode's stacked chunk (16 full tiles) and bottom edge tile with the
    fused front."""
    from hydrium_tpu_torch.encoder import buffer_shapes
    from hydrium_tpu_torch.jxl.frame import LFGroupGeometry

    h, w = img.shape[:2]
    cases = []

    def add(name, px, preset, lfg, seg, fused):
        _bh, _bw, uh, uw = buffer_shapes(lfg)
        up = np.zeros((uh, uw, 3), np.uint8)
        up[:lfg.height, :lfg.width] = px[:lfg.height, :lfg.width]
        cases.append((name, up, preset, lfg, seg, fused))

    for fused in (False, True):
        for y in range(-(-h // 2048)):
            for x in range(-(-w // 2048)):
                lfg = LFGroupGeometry(x=x, y=y,
                                      width=min(2048, w - x * 2048),
                                      height=min(2048, h - y * 2048),
                                      tile_count_x=8, tile_count_y=8)
                add(f"lfg{y}{x}{'_fused' if fused else ''}",
                    img[y * 2048:, x * 2048:], 2 * y + x, lfg, 0, fused)
    k_stack, tx = 4096 // TILE, w // TILE
    stack = np.concatenate([img[j // tx * TILE:(j // tx + 1) * TILE,
                                j % tx * TILE:(j % tx + 1) * TILE]
                            for j in range(k_stack)])   # in send order
    add("tiled_chunk_fused", stack, 0,
        LFGroupGeometry(x=0, y=0, width=TILE, height=k_stack * TILE,
                        tile_count_x=1, tile_count_y=k_stack),
        TILE >> 3, True)
    ty = h // TILE
    add("tiled_edge_fused", img[ty * TILE:, :TILE], 0,
        LFGroupGeometry(x=0, y=ty, width=TILE, height=h - ty * TILE,
                        tile_count_x=1, tile_count_y=1), 0, True)
    return cases


def check_graphs(img: np.ndarray, dev, smi: str) -> dict:
    """Phase 3, graphs: for each dispatch shape of phases 4 and 5
    (graph_cases), narrow and wide residues, the packed pipeline run
    eagerly, once more under torch.cuda.set_sync_debug_mode("error")
    (no operation of the body may wait on the device), then four times
    through ops/graphs.py, with two sets of pixels, presets and code
    tables in turn (its first call runs eagerly, its second captures and
    replays, the others replay): each payload's words equal the eager
    ones, and each call raises the launch counters by one dispatch's
    launches.  Per key: the eager and the graph call (median of 10
    between CUDA events, host work included), the capture's seconds and
    reserved MiB.  Returns {name: record}."""
    import torch

    from hydrium_tpu_torch.encoder import buffer_shapes
    from hydrium_tpu_torch.jxl.tokcode import TokenCodec
    from hydrium_tpu_torch.ops import graphs
    from hydrium_tpu_torch.ops import packed as TP
    from hydrium_tpu_torch.ops.front import FrontEnd

    front = FrontEnd.from_tables().to(dev)
    codec = TokenCodec()
    tabs = [codec.tables()[:2]]
    codec.update(np.random.default_rng(11).integers(0, 400, (10, 64)))
    tabs.append(codec.tables()[:2])
    tabs = [[torch.as_tensor(t.astype(np.int32), device=dev) for t in tab]
            for tab in tabs]
    out = {}
    for name, up, preset, lfg, seg, fused in graph_cases(img):
        buf_h, buf_w, _uh, _uw = buffer_shapes(lfg)
        G = (buf_h >> 8) * (buf_w >> 8)
        for wide in (False, True):
            kw = dict(buf_h=buf_h, buf_w=buf_w, linear_light=False,
                      sample_kind="uint8", lf_seg_vb=seg, tok_classes=9,
                      wide_residues=wide, fused=fused)
            inputs = [(torch.as_tensor(px, device=dev),
                       torch.full((G,), p, dtype=torch.int32, device=dev),
                       *tab) for px, p, tab in ((up, preset, tabs[0]),
                                                (255 - up, preset ^ 1,
                                                 tabs[1]))]

            def eager(i):
                px, pre, tl, tc = inputs[i]
                return TP.encode_lfg_packed(front, px, lfg.height, lfg.width,
                                            pre, tl, tc, **kw)

            def graphed(i):
                px, pre, tl, tc = inputs[i]
                return graphs.encode_lfg_packed(front, px, lfg.height,
                                                lfg.width, pre, tl, tc, **kw)

            eager(0)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                want = [eager(0), eager(1)]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            got = []
            for i in (0, 1, 0, 1):
                before = kernel_counts()
                got.append(graphed(i))
                after = kernel_counts()
                per = {k: after[k] - before[k] for k in after}
                assert per == {"transport_prep": 1, "chunk_pack": 1,
                               "frontend_tokens": int(fused),
                               "frontend_groups": 0}, (name, per)
            for g, e in zip(got, want + want):
                assert g.shape == e.shape and torch.equal(g, e), (
                    f"{name}: graph payload differs from eager in "
                    f"{int((g != e).sum())} words")
            stats = graphs.graph_stats()[str(inputs[0][0].device)]
            key = graphs.key_text(graphs.packed_key(
                front, inputs[0][0], lfg.height, lfg.width, **kw))
            rec, = [g for g in stats["graphs"] if g["key"] == key]
            tag = name + ("_wide" if wide else "")
            out[tag] = {"key": key, "ok_word": int(want[0][0]),
                        "words": want[0].numel(),
                        "eager_ms": _time_ms(lambda: eager(0), 10),
                        "graph_ms": _time_ms(lambda: graphed(0), 10),
                        "capture_s": rec["capture_s"],
                        "reserved_mib": rec["reserved_mib"]}
            print(f"graph {tag} ({key}): payload equal to eager, four "
                  f"times; eager {out[tag]['eager_ms']:.4f} ms, graph "
                  f"{out[tag]['graph_ms']:.4f} ms a call, capture "
                  f"{rec['capture_s']:.3f} s, {rec['reserved_mib']:.1f} MiB "
                  f"reserved, on {smi}", flush=True)
    return out


# the device kernel behind each launch counter, by the name a trace
# gives it (frontend_kernel serves both epilogues of the frontend)
TRACED_KERNELS = (("transport_prep", "transport_prep_kernel"),
                  ("chunk_pack", "chunk_pack_streams_kernel"),
                  ("frontend", "frontend_kernel"))


def traced(run, tries: int = 3):
    """Run an encode path (run() -> (result, stats), a fresh
    EncodeStats each call) under torch.profiler, its launch counts
    zeroed just before and read just after.  The device events of the
    trace count each kernel's launches by name; these must equal the
    wrappers' counts (frontend_kernel: frontend_tokens + frontend_groups),
    which a graph's replay adds for the kernels it launches without
    running the wrappers.  A trace that lost device events (fewer than
    counted) is taken again with the path run again, up to `tries`
    times; more than counted fails at once.  Returns (result, stats,
    counts, {kernel: launches seen}, attempts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        kernel_counts(zero=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result, stats = run()
            torch.cuda.synchronize()
        counts = kernel_counts()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {k: sum(1 for n in names if kernel in n)
                for k, kernel in TRACED_KERNELS}
        want = {"transport_prep": counts["transport_prep"],
                "chunk_pack": counts["chunk_pack"],
                "frontend": counts["frontend_tokens"]
                + counts["frontend_groups"]}
        if seen == want:
            return result, stats, counts, seen, attempt
        assert all(seen[k] <= want[k] for k in want), (
            f"the trace saw more launches than were counted: {seen}, "
            f"counted {want}")
        print(f"profiler trace {attempt} lost device events: saw {seen}, "
              f"counted {want}; the path runs again", flush=True)
    raise AssertionError(f"{tries} traces lost device events")


def kernel_counts(zero: bool = False) -> dict:
    """The kernel wrappers' launch counts (set to 0 first when `zero`)."""
    from hydrium_tpu_torch import bench

    return bench.kernel_counts(zero)


def multihost_child(addr: str, rank: str, out: str) -> int:
    """One of phase 8's two processes: join the gloo group, encode its
    presets' LF groups of the 4K image on the card with the fused front,
    print its wall, counters and kernel launches as one JSON line
    (process 0 also writes the file)."""
    import torch

    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch.parallel import multihost

    if not torch.cuda.is_available():
        print("chip_smoke child: CUDA is not available", file=sys.stderr)
        return 2
    import hydrium_tpu_torch as H

    img = make_4k()
    # first use of the card in this process (context, library load,
    # first launches) on a small encode of its own, outside the timing
    t0 = time.perf_counter()
    H.encode_image(np.random.default_rng(64).integers(
        0, 256, (64, 300, 3), dtype=np.uint8), device="cuda",
        fused_front=True)
    torch.cuda.synchronize()
    first_use = time.perf_counter() - t0
    multihost.initialize(addr, 2, int(rank))
    try:
        kernel_counts(zero=True)
        stats = EncodeStats()
        t0 = time.perf_counter()
        data = multihost.encode_image_multihost(
            img, device="cuda", stats=stats, fused_front=True,
            spool_dir=os.path.dirname(out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        multihost.shutdown()
    if data is not None:
        with open(out, "wb") as f:
            f.write(data)
    print(json.dumps({"rank": int(rank), "wall_s": wall,
                      "first_use_s": first_use,
                      "counters": dict(stats.counters),
                      "stages_s": {k: round(v, 4) for k, v in
                                   stats.stage_seconds.items()},
                      "launches": launches}), flush=True)
    return 0


def run_two_processes(out: str, timeout: float = 300) -> list:
    """Phase 8's two-process encode: this script twice as
    --multihost-child, gloo on a free localhost port; returns the two
    JSON records.  Both children are stopped whatever happens."""
    from hydrium_tpu_torch.scale import free_addr, run_processes

    addr = free_addr()
    return run_processes([[os.path.abspath(__file__), "--multihost-child",
                           addr, str(rank), out] for rank in range(2)],
                         os.path.dirname(out), timeout)


def check_parallel(img, want: dict, scratch: str, smi: str) -> dict:
    """Phase 8.  want: encode_image's bytes of img by front (False:
    unfused, True: fused).  Returns {path: record}, each with its
    launches."""
    import torch

    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch.parallel.driver import encode_image_sharded
    from hydrium_tpu_torch.parallel.dryrun import dryrun_multichip
    from hydrium_tpu_torch.utils.stats import device_trace

    runs = {}
    for entries in (1, 2):
        for fused in (False, True):
            name = f"sharded_{entries}" + ("_fused" if fused else "")
            kernel_counts(zero=True)
            stats = EncodeStats()
            t0 = time.perf_counter()
            got = encode_image_sharded(img, ["cuda:0"] * entries,
                                       stats=stats, fused_front=fused)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_counts()
            c = dict(stats.counters)
            stages = {k: round(v, 4) for k, v in stats.stage_seconds.items()}
            print(f"{name}: 3840x2160 over {entries} entries of cuda:0, "
                  f"{'fused' if fused else 'unfused'} front: {len(got)} "
                  f"bytes, {wall:.3f} s (cold codec) on {smi}, "
                  f"{n_dispatches(c)} dispatches, counters {c}, launches "
                  f"{launches}, stages {stages}", flush=True)
            assert got == want[fused], f"{name}: bytes differ from " \
                "encode_image's"
            assert c.get("lfg_packed") == 4 and not c.get("lfg_fallback"), c
            d = n_dispatches(c)
            assert c.get("codec_bootstraps") == 1, c
            assert launches["transport_prep"] == d, launches
            assert launches["chunk_pack"] == d, launches
            assert launches["frontend_tokens"] == (d if fused else 0)
            assert launches["frontend_groups"] == 0, launches
            runs[name] = {"wall_s": wall, "bytes": len(got), "counters": c,
                          "stages_s": stages, "launches": launches}

    name = "multihost_4k_fused"
    out = os.path.join(scratch, name + ".jxl")
    t0 = time.perf_counter()
    recs = run_two_processes(out)
    wall = time.perf_counter() - t0
    with open(out, "rb") as f:
        got = f.read()
    launches = {k: sum(r["launches"][k] for r in recs)
                for k in recs[0]["launches"]}
    counters = [r["counters"] for r in recs]
    print(f"{name}: two processes over gloo on cuda:0, fused front: "
          f"{len(got)} bytes; wall with process start {wall:.3f} s, encode "
          f"walls {[round(r['wall_s'], 4) for r in recs]} s (cold codec "
          f"each; first use of the card before it "
          f"{[round(r['first_use_s'], 4) for r in recs]} s) on {smi}; "
          f"{sum(n_dispatches(c) for c in counters)} dispatches, counters "
          f"{counters}, launches {launches}, stages by process "
          f"{[r['stages_s'] for r in recs]}", flush=True)
    assert got == want[True], f"{name}: bytes differ from encode_image's"
    assert [c.get("lfg_packed") for c in counters] == [2, 2], counters
    assert not any(c.get("lfg_fallback") for c in counters), counters
    d = sum(n_dispatches(c) for c in counters)
    assert launches["transport_prep"] == d, launches
    assert launches["chunk_pack"] == d, launches
    assert launches["frontend_tokens"] == d, launches
    assert launches["frontend_groups"] == 0, launches
    runs[name] = {"wall_s": wall, "encode_walls_s": [r["wall_s"]
                                                     for r in recs],
                  "bytes": len(got), "counters": counters,
                  "first_use_s": [r["first_use_s"] for r in recs],
                  "stages_s": [r["stages_s"] for r in recs],
                  "launches": launches}

    cpu_syms, cpu_bytes = dryrun_multichip(8, ["cpu"] * 8)
    kernel_counts(zero=True)
    trace_dir = os.path.join(scratch, "trace")
    t0 = time.perf_counter()
    with device_trace(trace_dir) as trace:
        syms, nbytes = dryrun_multichip(8, ["cuda:0"] * 8)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    with open(trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    traced = sorted(k for k in ("transport_prep_kernel",
                                "chunk_pack_streams_kernel")
                    if any(k in n for n in names))
    print(f"dryrun_multichip(8) on 8 entries of cuda:0: {syms} symbols, "
          f"{nbytes} section bytes (CPU: {cpu_syms}, {cpu_bytes}), "
          f"{wall:.3f} s inside device_trace; kernels in the trace "
          f"{traced}; launches {launches}", flush=True)
    assert abs(syms - cpu_syms) <= 1e-4 * cpu_syms, (syms, cpu_syms)
    assert traced == ["chunk_pack_streams_kernel",
                      "transport_prep_kernel"], traced
    assert launches["transport_prep"] == 8, launches
    assert launches["chunk_pack"] == 8, launches
    runs["dryrun_8"] = {"wall_s": wall, "symbols": syms,
                        "section_bytes": nbytes, "cpu_symbols": cpu_syms,
                        "cpu_section_bytes": cpu_bytes, "launches": launches}
    return runs


def check_bench(digests: dict, smi: str) -> dict:
    """Phase 10: the bench's device plane and rows on the card (module
    docstring).  digests: phase 4's and 5's sha256 by file.  Returns the
    phase's record with the rows' launches."""
    from hydrium_tpu_torch import bench

    t0 = time.perf_counter()
    dp = bench.device_plane(20, "cuda")
    for v in ("torch", "fused", "unpacked", "torch_graph", "fused_graph"):
        for k in ("ms_per_lfg", "mpix_s", "per_call_ms", "queued_ms_per_lfg"):
            assert dp[f"{v}_{k}"] > 0, (v, k, dp)
    # a replay counts the launches its graph captured
    for v in ("fused", "fused_graph"):
        assert dp[f"{v}_launches_per_call"] == {
            "transport_prep": 1, "chunk_pack": 1, "frontend_tokens": 1,
            "frontend_groups": 0}, (v, dp[f"{v}_launches_per_call"])
    assert dp["torch_graph_clone_ms"] > 0 and dp["fused_graph_clone_ms"] > 0
    print("device plane, ms a call back to back / single + sync, eager "
          "against graph: " + "; ".join(
              f"{v} {dp[f'{v}_ms_per_lfg']:.4f} / {dp[f'{v}_per_call_ms']:.4f}"
              for v in ("torch", "torch_graph", "fused", "fused_graph",
                        "unpacked"))
          + f"; clone {dp['fused_graph_clone_ms']:.4f} ms, on {smi}",
          flush=True)
    assert dp["fused_device_busy_ms_per_call"] > 0, dp
    assert len(dp["fused_top_ops"]) == 5, dp["fused_top_ops"]
    kernel_counts(zero=True)
    result, files = bench.rows(3, "cuda")
    launches = kernel_counts()
    for row in bench.ROWS:
        for fig, key in bench.row_keys(row).items():
            if fig != "walls_s":
                assert result[key] > 0, (key, result[key])
    assert launches["frontend_tokens"] > 0, launches
    assert launches["transport_prep"] == launches["chunk_pack"] > 0
    assert launches["frontend_groups"] == 0, launches
    got = {name: hashlib.sha256(files[row]).hexdigest()
           for name, row in (("one_frame", "value"),
                             ("tiled_fused", "tiled_fused"))}
    assert got == {k: digests[k] for k in got}, (got, digests)
    wall = time.perf_counter() - t0
    print(json.dumps({"bench": result, "device_plane": dp, "card": smi,
                      "sha256": got, "launches": launches,
                      "wall_s": wall}), flush=True)
    print(f"bench on the card: {wall:.3f} s; files equal phases 4 and 5",
          flush=True)
    return {"wall_s": wall, "launches": launches}


def strip_with_cpu_front(strip: np.ndarray, dev) -> dict:
    """Phase 11: the strip encoded on the card with the front's integers
    taken from the port's CPU front (ops/front.py::front_tokens patched,
    as tests/test_torch_e2e.py patches it to JAX's, and the dispatch's
    graph runner patched to the eager pipeline) must give the CPU
    encode's bytes; and the card's front against the CPU front on each
    of the strip's LF groups, within the flip bound."""
    import torch

    import hydrium_tpu_torch as H
    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch.ops import front as TF
    from hydrium_tpu_torch.ops import graphs
    from hydrium_tpu_torch.ops import packed as TP

    real, real_graphs = TF.front_tokens, graphs.encode_lfg_packed

    def cpu_front(front, pixels, *a, **k):
        out = real(TF.FrontEnd.from_tables(), pixels.cpu(), *a, **k)
        return {key: v.to(pixels.device) for key, v in out.items()}

    def eager(front, pixels, height, width, presets, tok_len, tok_code,
              **kw):
        # a front on the host cannot be captured: the eager pipeline,
        # which phase 3 holds the graphs to, runs on the card
        return TP.encode_lfg_packed(front, pixels, height, width, presets,
                                    tok_len.to(pixels.device),
                                    tok_code.to(pixels.device), **kw)

    t0 = time.perf_counter()
    want = H.encode_image(strip, device="cpu")
    cpu_wall = time.perf_counter() - t0
    TF.front_tokens, graphs.encode_lfg_packed = cpu_front, eager
    try:
        kernel_counts(zero=True)
        stats = EncodeStats()
        t0 = time.perf_counter()
        got = H.encode_image(strip, device="cuda", stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        TF.front_tokens, graphs.encode_lfg_packed = real, real_graphs
    flips = total = 0
    for x in range(0, strip.shape[1], 2048):
        f, n = front_flips(strip[:, x:x + 2048], dev, "uint16")
        flips, total = flips + f, total + n
    c = dict(stats.counters)
    return {"bytes": len(got), "equal": got == want, "wall_s": wall,
            "cpu_wall_s": cpu_wall, "counters": c, "launches": launches,
            "front_flips": flips, "front_values": total}


def graphs_mib(rec: dict) -> float:
    """The device memory that a scale.py record's process kept in live
    CUDA graphs at its end, MiB."""
    return sum(st["reserved_mib"] for st in rec["graphs"].values())


def check_scale(img16: np.ndarray, dev, smi: str) -> dict:
    """Phase 11 (module docstring): hydrium_tpu_torch/scale.py's configs
    4 and 5 on the card.  Returns {path: record}, each with the launches
    of its counted run."""
    from hydrium_tpu_torch import scale
    from hydrium_tpu_torch.ops.frontend import default_fused

    runs = {}
    for fused in (False, True):
        name = "config4" + ("_fused" if fused else "")
        r = scale.config4(device="cuda", fused_front=fused)
        c, d, launches = r["counters"], r["dispatches"], r["launches"]
        print(f"{name}: 7680x4320 u16 one-frame, "
              f"{'fused' if fused else 'default'} front: {r['bytes']} bytes "
              f"({r['bpp']:.4f} bpp), warm {r['seconds']:.3f} s "
              f"({r['mpix_s']:.3f} Mpix/s), cold {r['seconds_cold']:.3f} s, "
              f"on {smi}; PSNR {r['psnr_db']} ({r['psnr_note']}); counters "
              f"{c}, launches {launches}; stages {r['stage_seconds']}; "
              f"sha256 {r['sha256']}; device memory reserved at peak "
              f"{r['peak_reserved_mib']:.1f} MiB, of it graphs "
              f"{graphs_mib(r):.1f} MiB", flush=True)
        assert r["codestream_signature"] and not r["level10_container"], r
        assert c.get("lfg_packed") == 12 and not c.get("lfg_fallback"), c
        assert not c.get("codec_bootstraps"), c
        assert launches["transport_prep"] == launches["chunk_pack"] == d
        assert launches["frontend_tokens"] == (d if fused else 0), launches
        assert launches["frontend_groups"] == 0, launches
        runs[name] = r

    strip = np.ascontiguousarray(img16[4096:])
    r = strip_with_cpu_front(strip, dev)
    print(f"bottom strip 224x7680 u16 on the card, front from the CPU "
          f"front: {r['bytes']} bytes, equal to the CPU file: {r['equal']}; "
          f"{r['wall_s']:.3f} s on {smi} (CPU {r['cpu_wall_s']:.3f} s); "
          f"counters {r['counters']}, launches {r['launches']}; card front "
          f"vs CPU front {r['front_flips']} flips of {r['front_values']} "
          f"({r['front_flips'] / r['front_values']:.2e}, bound "
          f"{FRONT_FLIP_TOL:g})", flush=True)
    assert r["equal"], "bottom strip: card bytes differ from the CPU's"
    assert r["counters"].get("lfg_packed") == 4, r["counters"]
    d = n_dispatches(r["counters"])
    assert r["launches"]["transport_prep"] == d, r["launches"]
    assert r["launches"]["chunk_pack"] == d, r["launches"]
    assert r["front_flips"] <= FRONT_FLIP_TOL * r["front_values"], r
    runs["strip_cpu_front"] = r

    w, h = 16384, 16385
    cli = scale.config5_cli(w, h, device="cuda", timeout=600)
    multi = scale.config5_multi(
        w, h, device="cuda", timeout=600,
        reference={k: cli[k] for k in ("sha256", "bytes")})
    fused = default_fused()
    for name, r in (("config5_cli", cli), ("config5_multi", multi)):
        procs = r.get("per_process", [dict(r, wall_s=r.get("seconds"))])
        print(f"{name}: {w}x{h} u8 ({r['mpix']:.1f} Mpix), {r['bytes']} "
              f"bytes, level-10 container {r['level10_container']}, "
              f"{r['mpix_s']:.3f} Mpix/s on {smi}; walls "
              f"{[round(p['wall_s'], 3) for p in procs]} s"
              f", peak RSS {[round(p['peak_rss_mb'], 1) for p in procs]} "
              f"MiB, growth {[round(p['rss_growth_mb'], 1) for p in procs]} "
              f"MiB (bound {r['raw_mb'] / 2:.1f}); device memory reserved at "
              f"peak {[round(p['peak_reserved_mib'], 1) for p in procs]} "
              f"MiB, of it graphs {[round(graphs_mib(p), 1) for p in procs]} "
              f"MiB; dispatches "
              f"{r['dispatches']}, launches {r['launches']}"
              + (f"; PNG written in {r['png_write_s']:.3f} s"
                 if name == "config5_cli" else
                 f"; equal to config5_cli's file: {r['byte_identical']}"),
              flush=True)
        assert r["level10_container"], f"{name}: no level-10 prefix"
        for p in procs:
            assert p["rss_growth_mb"] <= r["raw_mb"] / 2, (name, p)
        assert r["launches"]["transport_prep"] == r["dispatches"], r
        assert r["launches"]["chunk_pack"] == r["dispatches"], r
        assert r["launches"]["frontend_tokens"] == (
            r["dispatches"] if fused else 0), r["launches"]
        runs[name] = r
    assert cli["counters"].get("lfg_packed") == 72, cli["counters"]
    assert not cli["counters"].get("lfg_fallback"), cli["counters"]
    assert sum(p["counters"].get("lfg_packed", 0)
               for p in multi["per_process"]) == 72, multi
    assert multi["byte_identical"], "config5_multi: bytes differ from the CLI's"
    return runs


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import hydrium_tpu_torch
    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch import encoder as torch_encoder
    from hydrium_tpu_torch.ops import _kernels, graphs
    from hydrium_tpu_torch.scale import config4_image, write_png

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    # the transport codec's warm state: an empty directory of this run's
    # own, so the first encode starts cold and nothing of the user's is
    # read or written
    scratch = tempfile.TemporaryDirectory(prefix="hyd_smoke_")
    torch_encoder.reset_warm_state(os.path.join(scratch.name, "warm.npz"))

    # phase 2: build
    t_build = _kernels.build()
    _kernels.lib()
    print(f"kernel build: {t_build:.1f} s -> {_kernels.library_path()}",
          flush=True)

    # phase 3: kernels vs plain twins
    img = make_4k()
    img16 = config4_image()
    results = check_kernels(dev)
    results.extend(check_frontend(img, img16, dev))
    graph_runs = check_graphs(img, dev, smi)
    # the encodes below start with no graph, as a process does: each
    # key's first dispatch eager, its second captured
    graphs.clear_graphs()

    # phase 4: one-frame mode
    kernel_counts(zero=True)
    stats = EncodeStats()
    t0 = time.perf_counter()
    data = hydrium_tpu_torch.encode_image(img, device="cuda", stats=stats)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = kernel_counts()
    c = stats.counters
    print(f"encode 3840x2160 u8 (cold): {len(data)} bytes, {t_cold:.3f} s, "
          f"counters {dict(c)}, launches {launches}", flush=True)
    assert c.get("lfg_packed", 0) == 4, c
    assert c.get("lfg_fallback", 0) == 0, c
    assert c.get("codec_bootstraps", 0) == 1, c     # the cold start
    dispatches = n_dispatches(c)
    assert launches["transport_prep"] == dispatches, launches
    assert launches["chunk_pack"] == dispatches, launches
    assert launches["frontend_groups"] == launches["frontend_tokens"] == 0
    assert data[:2] == b"\xff\x0a", data[:4].hex()

    warm_stats = EncodeStats()
    t0 = time.perf_counter()
    data2 = hydrium_tpu_torch.encode_image(img, device="cuda",
                                           stats=warm_stats)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    assert data2 == data, "second encode is not byte-identical"
    mpix = img.shape[0] * img.shape[1] / 1e6
    stages = {k: round(v, 4) for k, v in warm_stats.stage_seconds.items()}
    print(f"encode 3840x2160 u8 (warm): {t_warm:.3f} s, "
          f"{mpix / t_warm:.2f} Mpix/s on {smi}; stages {stages}",
          flush=True)

    # the same one-frame encode with the fused front, for its launches,
    # which a trace holds to the counters
    def one_frame_fused():
        st = EncodeStats()
        return hydrium_tpu_torch.encode_image(
            img, device="cuda", stats=st, fused_front=True), st

    fused_data, f_stats, fused_launches, fused_seen, tries = traced(
        one_frame_fused)
    fc = f_stats.counters
    print(f"encode 3840x2160 u8, fused front: {len(fused_data)} bytes, "
          f"counters {dict(fc)}, launches {fused_launches}, equal to the "
          f"kernels a trace saw launched ({fused_seen}, trace {tries})",
          flush=True)
    assert fc.get("lfg_packed", 0) == 4 and not fc.get("lfg_fallback"), fc
    # the fused front tokenizes in the kernel: the tokens epilogue once
    # per dispatch, the q/dc epilogue never
    assert fused_launches["frontend_tokens"] == fused_launches[
        "transport_prep"] == n_dispatches(fc)
    assert fused_launches["frontend_groups"] == 0, fused_launches
    assert fused_data[:2] == b"\xff\x0a"

    flips, total = front_flips(img[:2048, :2048], dev)
    print(f"front flips card vs CPU (LF group 0,0): {flips} of {total} "
          f"({flips / total:.2e}, bound {FRONT_FLIP_TOL:g})", flush=True)
    assert flips <= FRONT_FLIP_TOL * total, (flips, total)

    if ctypes.util.find_library("jxl") is None:
        print("decode PSNR: not run (no libjxl on this machine)", flush=True)
    else:
        from hydrium_tpu_torch.utils import djxl   # libjxl oracle

        dec = djxl.decode(data)
        assert dec.shape == img.shape, dec.shape
        print(f"decode PSNR: {djxl.psnr(img / 255.0, dec):.4f} dB",
              flush=True)

    # phase 5: tiled mode with the fused front (this slice's path)
    th_full, tw_full = img.shape[0] // TILE, img.shape[1] // TILE
    n_full = th_full * tw_full
    n_edge = (-(-img.shape[0] // TILE) * -(-img.shape[1] // TILE)) - n_full
    k_stack = 4096 // TILE
    n_chunks = -(-n_full // k_stack)   # rows are full: runs span rows
    # the main path's launches are those a torch.profiler trace of it saw
    # (traced: equal to the counters, which replays add to)
    def tiled_fused():
        st = EncodeStats()
        return encode_tiled(img, True, st), st

    t0 = time.perf_counter()
    tiled, t_stats, tiled_launches, tiled_seen, tries = traced(tiled_fused)
    t_tiled_cold = time.perf_counter() - t0
    tc = t_stats.counters
    dispatches = n_dispatches(tc)
    print(f"tiled 3840x2160 u8, 256^2 tiles, fused front (cold, under "
          f"torch.profiler): {len(tiled)} bytes, {t_tiled_cold:.3f} s, "
          f"counters {dict(tc)}, launches {tiled_launches}, equal to the "
          f"kernels the trace saw launched ({tiled_seen}, trace {tries}); "
          f"expect {n_chunks} chunks + {n_edge} edge tiles", flush=True)
    assert tc.get("lfg_packed", 0) == n_chunks + n_edge, tc
    assert tc.get("lfg_fallback", 0) == 0, tc
    assert tiled_launches["frontend_tokens"] == dispatches > 0, tiled_launches
    assert tiled_launches["frontend_groups"] == 0, tiled_launches
    assert tiled_launches["transport_prep"] == dispatches, tiled_launches
    assert tiled_launches["chunk_pack"] == dispatches, tiled_launches
    assert tiled[:2] == b"\xff\x0a", tiled[:4].hex()

    tw_stats = EncodeStats()
    t0 = time.perf_counter()
    tiled2 = encode_tiled(img, True, tw_stats)
    t_tiled_warm = time.perf_counter() - t0
    assert tiled2 == tiled, "second tiled encode is not byte-identical"
    # every graph that phases 4 and 5 left (the cache's, least recently
    # used first) has a key that phase 3 held against the eager pipeline
    live = graphs.graph_stats()
    print(f"graphs after phases 4 and 5: {json.dumps(live)}", flush=True)
    unchecked = ({g["key"] for st in live.values() for g in st["graphs"]}
                 - {r["key"] for r in graph_runs.values()})
    assert not unchecked, f"keys not held against eager: {unchecked}"
    tiled_stages = {k: round(v, 4) for k, v in tw_stats.stage_seconds.items()}
    digests = {name: hashlib.sha256(b).hexdigest() for name, b in (
        ("one_frame", data), ("one_frame_fused", fused_data),
        ("tiled_fused", tiled))}
    print(f"sha256 of the 4K files: {digests}", flush=True)
    print(f"tiled (warm, fused front): {t_tiled_warm:.3f} s, "
          f"{mpix / t_tiled_warm:.2f} Mpix/s on {smi}; stages "
          f"{tiled_stages}", flush=True)
    kernel_counts(zero=True)
    tu_stats = EncodeStats()
    t0 = time.perf_counter()
    tiled_unfused = encode_tiled(img, False, tu_stats)
    t_tiled_unfused = time.perf_counter() - t0
    unfused_launches = kernel_counts()
    assert tiled_unfused[:2] == b"\xff\x0a"
    assert tu_stats.counters.get("lfg_fallback", 0) == 0, tu_stats.counters
    assert unfused_launches["frontend_groups"] == unfused_launches[
        "frontend_tokens"] == 0, unfused_launches
    assert unfused_launches["transport_prep"] == n_dispatches(
        tu_stats.counters)
    print(f"tiled (warm, unfused front): {t_tiled_unfused:.3f} s, "
          f"{mpix / t_tiled_unfused:.2f} Mpix/s, {len(tiled_unfused)} bytes, "
          f"launches {unfused_launches}", flush=True)
    if ctypes.util.find_library("jxl") is not None:
        from hydrium_tpu_torch.utils import djxl

        dec = djxl.decode(tiled)
        assert dec.shape == img.shape, dec.shape
        print(f"tiled decode PSNR: {djxl.psnr(img / 255.0, dec):.4f} dB",
              flush=True)

    # phase 6: the command line on the card
    png = os.path.join(scratch.name, "in.png")
    pfm = os.path.join(scratch.name, "in.pfm")
    write_png(png, img)
    rng = np.random.default_rng(768)
    yy = np.arange(768, dtype=np.float32)[:, None, None]
    xx = np.arange(1024, dtype=np.float32)[None, :, None]
    img_f32 = np.clip(0.4 + 0.3 * np.sin(xx / 61.0) * np.cos(yy / 37.0)
                      + rng.normal(0, 0.03, (768, 1024, 3)), 0,
                      1).astype(np.float32)
    write_pfm(pfm, img_f32)
    cli_runs = {}
    for name, src, flags, arr, fused, shift, linear, n_units in (
            ("cli_one_frame", png, ["--one-frame"], img, False, -1, False, 4),
            ("cli_tiled_fused", png, ["--tile-size=0"], img, True, 0, False,
             n_chunks + n_edge),
            ("cli_pfm_linear_fused", pfm, ["--linear"], img_f32, True, -1,
             True, 1)):
        out_path = os.path.join(scratch.name, name + ".jxl")
        kernel_counts(zero=True)
        t0 = time.perf_counter()
        rc, cc, stg = run_cli([src, out_path] + flags, fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got_launches = kernel_counts()
        with open(out_path, "rb") as f:
            got = f.read()
        want = hydrium_tpu_torch.encode_image(
            arr, shift, linear_light=linear, device="cuda", fused_front=fused)
        print(f"{name}: exit {rc}, {len(got)} bytes, {wall:.3f} s with the "
              f"input read, counters {cc}, launches {got_launches}",
              flush=True)
        assert rc == 0, rc
        assert got[:2] == b"\xff\x0a", got[:4].hex()
        assert got == want, f"{name}: bytes differ from encode_image"
        assert cc.get("lfg_packed", 0) == n_units, cc
        assert cc.get("lfg_fallback", 0) == 0, cc
        d = n_dispatches(cc)
        assert got_launches["transport_prep"] == d, got_launches
        assert got_launches["chunk_pack"] == d, got_launches
        assert got_launches["frontend_tokens"] == (d if fused else 0)
        assert got_launches["frontend_groups"] == 0, got_launches
        cli_runs[name] = {"bytes": len(got), "wall_s": wall, "counters": cc,
                          "launches": got_launches}
        if ctypes.util.find_library("jxl") is not None:
            from hydrium_tpu_torch.utils import djxl

            dec = djxl.decode(got)
            assert dec.shape == arr.shape, dec.shape
            ref = arr / 255.0 if arr.dtype == np.uint8 else arr
            print(f"{name} decode PSNR: {djxl.psnr(ref, dec):.4f} dB",
                  flush=True)

    # phase 7: overlap on against overlap off, and the prep pool
    overlap = check_overlap(img, digests, data, smi)

    # phase 8: multi-device and multi-process
    parallel = check_parallel(img, {False: data, True: fused_data},
                              scratch.name, smi)

    # phase 9: the conformance profile, which launches no kernel
    conformance = check_conformance(scratch.name, smi)

    # phase 10: the bench on the card
    bench_run = check_bench(digests, smi)

    # phase 11: BASELINE configs 4 and 5
    scale_runs = check_scale(img16, dev, smi)
    scratch.cleanup()

    # "launches" is the tiled run with the fused front, the main path:
    # transport prep, chunk pack and the frontend kernel's tokens
    # epilogue.  Its q/dc epilogue (frontend_groups) is on no encode path
    # since the fused front tokenizes in the kernel; it launches only in
    # phase 3.  Each path's counts were zeroed just before it.
    paths = {"one_frame": launches, "one_frame_fused": fused_launches,
             "tiled_fused": tiled_launches, "tiled": unfused_launches}
    paths.update({k: v["launches"] for k, v in cli_runs.items()})
    paths.update({k: v["launches"] for k, v in parallel.items()})
    paths["conformance"] = conformance["launches"]
    paths["bench_rows"] = bench_run["launches"]
    paths.update({k: v["launches"] for k, v in scale_runs.items()})
    traced_main = {"transport_prep": tiled_seen["transport_prep"],
                   "chunk_pack": tiled_seen["chunk_pack"],
                   "frontend_tokens": tiled_seen["frontend"]
                   - tiled_launches["frontend_groups"],
                   "frontend_groups": tiled_launches["frontend_groups"]}
    for r in results:
        # launches seen in the main path's trace, equal to the count
        r["launches"] = traced_main[r["name"]]
        r["launches_counted"] = tiled_launches[r["name"]]
        r["on_main_path"] = r["name"] != "frontend_groups"
        r["launches_by_path"] = {k: v[r["name"]] for k, v in paths.items()}
    # the whole wall, build and every phase, before the last two lines
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": results, "encode_4k": {
        "bytes": len(data), "cold_s": t_cold, "warm_s": t_warm,
        "mpix_per_s": mpix / t_warm, "stages_s": stages,
        "front_flips": flips,
        "front_coeffs": total, "card": smi}, "tiled_4k": {
        "bytes": len(tiled), "cold_s": t_tiled_cold, "warm_s": t_tiled_warm,
        "mpix_per_s": mpix / t_tiled_warm, "stages_s": tiled_stages,
        "unfused_warm_s": t_tiled_unfused, "chunks": n_chunks,
        "edge_tiles": n_edge, "counters": dict(tc)}, "cli": cli_runs,
        "graphs": {"checked": graph_runs, "stats": graphs.graph_stats()},
        "overlap": overlap, "parallel": parallel,
        "conformance": conformance, "scale": {
            k: {f: v for f, v in r.items() if f != "launches"}
            for k, r in scale_runs.items()}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(multihost_child(*sys.argv[2:5]))
    sys.exit(main())
