#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hydrium_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from hydrium_tpu_torch/csrc;
3. each kernel against its plain torch twin on the card, at the shapes
   one 2048x2048 LF group gives it: exact equality of every output,
   median CUDA-event times of kernel and twin;
4. the main path: hydrium_tpu_torch.encode_image on a 3840x2160 u8 image
   (noise + sinusoid, from a seed), one frame of four LF groups.  Checks:
   all four LF groups packed, no fallback, both kernels launched by the
   encode, the JPEG XL signature, a byte-identical second encode, the
   card's front integers against the port's CPU front on one 2048^2 LF
   group (flip rate <= 1e-4), and, where libjxl loads, decode PSNR.

Prints one JSON line of kernel results, then as the last line
{"ok": true, "device": {...}}.
"""

import ctypes.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# flip-rate bound of the card's front vs the CPU front (float32 sums in
# another order and FMA contraction move a few truncations per million)
FRONT_FLIP_TOL = 1e-4


def _time_ms(fn, reps: int = 20) -> float:
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


def _transport_case(rng, dev, N: int):
    import torch

    tokens = rng.integers(0, 80, (N, 64)).astype(np.int16)
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


def check_kernels(dev):
    """Phase 3: each kernel vs its plain twin at main-path shapes."""
    import torch

    from hydrium_tpu_torch.ops import constants as C
    from hydrium_tpu_torch.ops.bitpack import pack_chunks, pack_chunks_plain
    from hydrium_tpu_torch.ops.transport import (transport_prep,
                                                 transport_prep_plain)

    rng = np.random.default_rng(2160)
    N = 64 * 3072                    # one 2048^2 LF group: G=64 groups
    results = []

    args = _transport_case(rng, dev, N)
    got = transport_prep(*args, tok_classes=9)
    want = transport_prep_plain(*args, tok_classes=9)
    torch.cuda.synchronize()
    names = ("t_flat", "t_bits", "r_flat", "r_bits")
    for g, w, n in zip(got, want, names):
        if not torch.equal(g, w):
            bad = int((g != w).sum().item())
            raise AssertionError(f"transport_prep {n}: {bad} mismatches")
    err = max(int((g.long() - w.long()).abs().max().item())
              for g, w in zip(got, want))
    ms = _time_ms(lambda: transport_prep(*args, tok_classes=9))
    plain_ms = _time_ms(lambda: transport_prep_plain(*args, tok_classes=9))
    print(f"transport_prep N={N}: equal, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    results.append({"name": "transport_prep", "route": "cuda",
                    "source": "hydrium_tpu_torch/csrc/transport_prep.cu",
                    "replaces": "hydrium_tpu/ops/pallas/prep.py:221",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "shape": f"N={N}"})

    M = N * 64
    cases = [
        ("tokens", M // C.TOK_CHUNK, C.TOK_CHUNK, C.TOK_OW, C.TOK_MAX_LEN,
         0.35, 0),
        ("residues_fast", M // C.RES_CHUNK, C.RES_CHUNK, C.RES_OW_FAST,
         C.RES_CAP_FAST, 0.4, 0),
        ("residues_wide", M // C.RES_CHUNK, C.RES_CHUNK, C.RES_OW_WIDE,
         C.RES_CAP_WIDE, 0.2, 2),
    ]
    pack_err, pack_ms, pack_plain_ms, shapes = 0, {}, {}, []
    for name, R, ch, ow, cap, p, ovf in cases:
        vals, widths = _pack_case(rng, dev, R, ch, cap, p, ovf)
        got = pack_chunks(vals, widths, ch, ow)
        want = pack_chunks_plain(vals, widths, ch, ow)
        torch.cuda.synchronize()
        for g, w, n in zip(got, want, ("chunks", "chunk_bits")):
            if not torch.equal(g, w):
                bad = int((g != w).sum().item())
                raise AssertionError(f"pack_chunks {name} {n}: {bad} "
                                     "mismatches")
        pack_err = max(pack_err, max(
            int((g.long() - w.long()).abs().max().item())
            for g, w in zip(got, want)))
        pack_ms[name] = _time_ms(lambda: pack_chunks(vals, widths, ch, ow))
        pack_plain_ms[name] = _time_ms(
            lambda: pack_chunks_plain(vals, widths, ch, ow))
        shapes.append(f"{name}: R={R} ch={ch} ow={ow}")
        print(f"pack_chunks {name} R={R} ch={ch} ow={ow} cap={cap}: equal, "
              f"kernel {pack_ms[name]:.4f} ms, plain "
              f"{pack_plain_ms[name]:.4f} ms", flush=True)
    results.append({"name": "chunk_pack", "route": "cuda",
                    "source": "hydrium_tpu_torch/csrc/chunk_pack.cu",
                    "replaces": "hydrium_tpu/ops/pallas/bitpack.py:203",
                    "max_abs_err": pack_err,
                    "ms": pack_ms["tokens"] + pack_ms["residues_fast"],
                    "plain_ms": (pack_plain_ms["tokens"]
                                 + pack_plain_ms["residues_fast"]),
                    "ms_by_case": pack_ms, "plain_ms_by_case": pack_plain_ms,
                    "shape": "; ".join(shapes)})
    return results


def make_4k(seed: int = 0) -> np.ndarray:
    """3840x2160 u8: sinusoid plus Gaussian noise (bench.py make_4k_noisy)."""
    rng = np.random.default_rng(seed)
    h, w = 2160, 3840
    yy = np.arange(h, dtype=np.float32)[:, None, None]
    xx = np.arange(w, dtype=np.float32)[None, :, None]
    phase = np.array([0.0, 1.3, 2.1], np.float32)
    base = 128 + 80 * np.sin(xx / 97.0 + phase) * np.cos(yy / 53.0 - phase)
    noise = rng.normal(0, 24, (h, w, 3)).astype(np.float32)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def front_flips(img: np.ndarray, dev) -> tuple:
    """The card's front integers vs the port's CPU front, LF group (0,0)."""
    import torch

    from hydrium_tpu_torch.ops.front import FrontEnd

    px = img[:2048, :2048]
    kw = dict(buf_h=2048, buf_w=2048, linear_light=False,
              sample_kind="uint8")
    outs = []
    for d in (dev, torch.device("cpu")):
        fe = FrontEnd.from_tables().to(d)
        q, lf = fe(torch.as_tensor(px, device=d), 2048, 2048, **kw)
        outs.append((q.cpu(), lf.cpu()))
    (qg, lg), (qc, lc) = outs
    flips = int((qg != qc).sum().item()) + int((lg != lc).sum().item())
    return flips, qg.numel() + lg.numel()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import hydrium_tpu_torch
    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch.ops import _kernels
    from hydrium_tpu_torch.ops.bitpack import pack_chunks
    from hydrium_tpu_torch.ops.transport import transport_prep

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")

    # phase 2: build
    t_build = _kernels.build()
    _kernels.lib()
    print(f"kernel build: {t_build:.1f} s -> {_kernels.library_path()}",
          flush=True)

    # phase 3: kernels vs plain twins
    results = check_kernels(dev)

    # phase 4: the main path
    img = make_4k()
    transport_prep.launches = 0
    pack_chunks.launches = 0
    stats = EncodeStats()
    t0 = time.perf_counter()
    data = hydrium_tpu_torch.encode_image(img, device="cuda", stats=stats)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = {"transport_prep": transport_prep.launches,
                "chunk_pack": pack_chunks.launches}
    c = stats.counters
    print(f"encode 3840x2160 u8 (cold): {len(data)} bytes, {t_cold:.3f} s, "
          f"counters {dict(c)}, launches {launches}", flush=True)
    assert c.get("lfg_packed", 0) == 4, c
    assert c.get("lfg_fallback", 0) == 0, c
    assert launches["transport_prep"] >= 4, launches
    assert launches["chunk_pack"] >= 8, launches
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

    flips, total = front_flips(img, dev)
    print(f"front flips card vs CPU (LF group 0,0): {flips} of {total} "
          f"({flips / total:.2e}, bound {FRONT_FLIP_TOL:g})", flush=True)
    assert flips <= FRONT_FLIP_TOL * total, (flips, total)

    if ctypes.util.find_library("jxl") is None:
        print("decode PSNR: not run (no libjxl on this machine)", flush=True)
    else:
        from hydrium_tpu.utils import djxl   # the repo's libjxl oracle

        dec = djxl.decode(data)
        assert dec.shape == img.shape, dec.shape
        print(f"decode PSNR: {djxl.psnr(img / 255.0, dec):.4f} dB",
              flush=True)

    for r in results:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": results, "encode_4k": {
        "bytes": len(data), "cold_s": t_cold, "warm_s": t_warm,
        "mpix_per_s": mpix / t_warm, "stages_s": stages,
        "front_flips": flips,
        "front_coeffs": total, "card": smi}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
