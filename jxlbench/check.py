"""Deciding `correct`: every distinct file the window produced is parsed
whole by the plain reference decoder (jxlbench/ref) and its coefficients
are held to the exact quantizer inputs of the image it came from.

Identical files are one answer, so every image of the window is covered
once each distinct file is judged.  The files are judged in worker
processes started with spawn, which import numpy and jxlbench.ref only;
the pool is closed and joined before the verdict returns."""

from __future__ import annotations

import math
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Dict, List

import numpy as np

# the sample formats the reference front computes (ref/front.py)
FORMATS = {"uint8": np.uint8}


def judge_file(img: np.ndarray, data: bytes) -> dict:
    """Worker: parse one file and hold it to its image."""
    from jxlbench.ref.bits import ParseFault
    from jxlbench.ref.compare import judge
    from jxlbench.ref.decode import decode
    from jxlbench.ref.front import reference_inputs

    try:
        c = decode(data)
    except ParseFault as e:
        return {"parse_fault": str(e)}
    if (c.height, c.width) != img.shape[:2]:
        return {"parse_fault": f"size {c.width}x{c.height}, the image is "
                               f"{img.shape[1]}x{img.shape[0]}"}
    u_lf, u_hf = reference_inputs(img)
    return judge(u_lf, u_hf, c.lf, c.hf)


def judge_window(images: np.ndarray, files: Dict[int, Dict[str, bytes]],
                 uses: Dict[int, Dict[str, int]], config: dict,
                 workers: int = 4) -> dict:
    """Judges every distinct file of the window against the configuration
    (its sample_format and limits).
    -> {"checks": {name: {"value", "limit"}}, "failed": images whose
    file failed, "files": distinct files judged, "faults": [...]}"""
    fmt = config["sample_format"]
    if fmt not in FORMATS or images.dtype != FORMATS[fmt]:
        raise ValueError(f"jxlbench: the reference judges "
                         f"{', '.join(FORMATS)} images; the configuration "
                         f"states {fmt!r} and the images are {images.dtype}")
    limits = config["limits"]
    todo = [(k, key) for k in sorted(files) for key in files[k]]
    ctx = get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(todo)) or 1,
                             mp_context=ctx) as ex:
        futs = [ex.submit(judge_file, images[k], files[k][key])
                for k, key in todo]
        res = [f.result() for f in futs]
    faults: List[str] = []
    margin, flips, coeffs, failed = 0.0, 0, 0, 0
    for (k, key), r in zip(todo, res):
        bad = "parse_fault" in r
        if bad:
            faults.append(f"image {k}: {r['parse_fault']}")
        else:
            margin = max(margin, r["margin_max"])
            flips += r["flips"]
            coeffs += r["coefficients"]
            bad = r["margin_max"] > limits["margin_max"]
        if bad:
            failed += uses[k][key]
    checks = {"parse_faults": {"value": len(faults),
                               "limit": limits["parse_faults"]},
              "margin_max": {"value": margin if not math.isinf(margin)
                             else 1e9, "limit": limits["margin_max"]}}
    return {"checks": checks, "failed": failed, "files": len(todo),
            "flip_share": flips / coeffs if coeffs else None,
            "faults": faults}
