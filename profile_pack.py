#!/usr/bin/env python3
"""Device time of the chunk-pack kernel (csrc/chunk_pack.cu) on one CUDA
card, as the packed tail calls it.

    python3 profile_pack.py [--root DIR] [--reps 20]
    python3 profile_pack.py [--root DIR] --variant DIR OLD NEW [OLD NEW ...]

Packs the token stream with the fast or the wide residue stream of one
dispatch, fields drawn from a seed by chip_smoke.py's _pack_case, at the
shapes the encode paths give it: one 2048^2 LF group (3072 token + 6144
residue chunks), one stacked tiled chunk (768 + 1536) and one edge tile
(48 + 96); and each stream alone.  A pair goes through
ops/bitpack.py::pack_chunk_streams (one launch) where --root has it,
else through two pack_chunks calls, so an older checkout (say, an
unpacked parent commit) is timed the same way in the same call.  Each
call runs, with a synchronize, inside a torch.profiler range; the
device events that start inside it are the call's (profile_front.py's
_profile).  Prints per case the median device time per call, the device
events per call, the median time of one call between CUDA events (host
work included), the bound (bytes over 3.35 TB/s: 8 per field read, the
rows and chunk_bits written) and whether both outputs equal the plain
twin.  The last line is one JSON object of these numbers.

--variant copies --root's hydrium_tpu_torch into DIR with each text
OLD of csrc/chunk_pack.cu (each must occur once) replaced by its NEW,
and exits: an ablation of the kernel that a later run times with
--root DIR (it builds its own library under DIR/build).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

# this checkout's helpers, imported before --root goes on sys.path
from chip_smoke import HBM_BYTES_PER_S, _pack_bytes, _pack_case
from profile_front import _profile

# (shape, token chunks); residue chunks are twice as many
SHAPES = (("lfg", 3072), ("chunk", 768), ("edge", 48))


def make_variant(root: str, dst: str, pairs) -> None:
    """Copy root's hydrium_tpu_torch to dst with each (old, new) of
    pairs applied to csrc/chunk_pack.cu (old occurring exactly once)."""
    out = os.path.join(dst, "hydrium_tpu_torch")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, "hydrium_tpu_torch"), out,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(out, "csrc", "chunk_pack.cu")
    with open(cu) as f:
        text = f.read()
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"profile_pack: {old!r} occurs "
                             f"{text.count(old)} times in chunk_pack.cu, "
                             "want once")
        text = text.replace(old, new)
    with open(cu, "w") as f:
        f.write(text)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", nargs="+", metavar="DIR OLD NEW")
    args = ap.parse_args()
    if args.variant:
        dst, rest = args.variant[0], args.variant[1:]
        if not rest or len(rest) % 2:
            raise SystemExit("profile_pack: --variant DIR OLD NEW "
                             "[OLD NEW ...]")
        make_variant(args.root, dst, list(zip(rest[::2], rest[1::2])))
        return 0

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_pack: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from hydrium_tpu_torch.ops import _kernels
    from hydrium_tpu_torch.ops import bitpack as TB
    from hydrium_tpu_torch.ops import constants as C

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t_build = _kernels.build()
    _kernels.lib()
    pair_call = getattr(TB, "pack_chunk_streams", None)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2160)
    result = {"card": smi, "root": root, "build_s": t_build,
              "one_launch_pair": pair_call is not None}
    for shape, r_tok in SHAPES:
        tok = _pack_case(rng, dev, r_tok, C.TOK_CHUNK, C.TOK_MAX_LEN,
                         0.35) + (C.TOK_CHUNK, C.TOK_OW)
        res = {"fast": _pack_case(rng, dev, 2 * r_tok, C.RES_CHUNK,
                                  C.RES_CAP_FAST, 0.4)
               + (C.RES_CHUNK, C.RES_OW_FAST),
               "wide": _pack_case(rng, dev, 2 * r_tok, C.RES_CHUNK,
                                  C.RES_CAP_WIDE, 0.2, 2)
               + (C.RES_CHUNK, C.RES_OW_WIDE)}
        cases = {f"pair_{k}": (tok, r) for k, r in res.items()}
        cases["tokens"] = (tok,)
        cases["residues_fast"] = (res["fast"],)
        for name, streams in cases.items():
            if len(streams) == 2 and pair_call is not None:
                run = lambda s=streams: pair_call(*s)
            else:
                run = lambda s=streams: tuple(TB.pack_chunks(*st)
                                              for st in s)
            got = run()
            want = [TB.pack_chunks_plain(*st) for st in streams]
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for g, w in zip(got, want)
                        for a, b in zip(g, w))
            rec = _profile(run, args.reps)
            rec["bound_ms"] = sum(map(_pack_bytes, streams)) \
                / HBM_BYTES_PER_S * 1e3
            rec["equal"] = equal
            key = f"{shape}/{name}"
            result[key] = rec
            print(f"{key} R={[st[0].shape[0] // st[2] for st in streams]}: "
                  f"device {rec['device_ms']:.4f} ms "
                  f"({rec['bound_ms'] / rec['device_ms']:.0%} of "
                  f"{rec['bound_ms']:.5f}) in "
                  f"{rec['device_events_per_call']:.1f} events per call, "
                  f"one call host included {rec['call_ms']:.4f} ms, "
                  f"{'equal' if equal else 'DIFFERS from the plain twin'}",
                  flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
