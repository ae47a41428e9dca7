"""Multi-process encoding: torch.distributed glue, the cross-process
bitstream gather, and per-LF-group failure recovery.

LF groups are spread over processes in whole histogram presets, so the
per-preset histograms never cross a process: each process encodes and
ANS-codes its own presets' LF groups, and only the finished sections
and cluster frequencies travel, as host bytes, to process 0, which
writes the headers and the TOC.  The process group uses the gloo
backend: the payload is bytes on the host, never a device tensor.
Groups are idempotent -- any LF group's sections can be recomputed
from its pixels, which is the whole failure-recovery story
(`with_retry`).

A process of a multi-process encode from the command line (the image
a .npy file, read memory-mapped; process 0 writes the .jxl):

    python -m hydrium_tpu_torch.parallel.multihost HOST:PORT N RANK \\
        image.npy out.jxl [--device cpu]

The front follows HYDRIUM_PALLAS, as the port's CLI does.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join a gloo process group whose rank 0 listens on
    `coordinator_address` ("host:port"); a no-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Processes in the group (1 when none was initialized)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank (0 when no group was initialized)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def with_retry(fn: Callable, attempts: int = 3, backoff: float = 0.5):
    """Idempotent-shard retry wrapper: an LF group's encode has no side
    effects until its symbols are fed to the HF stream, and every
    failure the device path reports (a checksum mismatch) raises before
    that, so a failed step is recovered by recomputation."""

    def wrapped(*args, **kwargs):
        last = None
        for i in range(attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - deliberate broad retry
                last = e
                if i + 1 < attempts:
                    time.sleep(backoff * (2 ** i))
        raise last

    return wrapped


def gather_bytes_to_host0(payload: bytes) -> Optional[list]:
    """Gather variable-length byte strings to process 0; returns the
    list (by rank) on process 0, None elsewhere.  Point to point over
    gloo: every other process sends its length, then its bytes, and
    process 0 receives them one process at a time, so that only process
    0 holds the others' bytes, each once and unpadded."""
    n = process_count()
    if n == 1:
        return [payload]
    import torch.distributed as dist

    if process_index() != 0:
        dist.send(torch.tensor([len(payload)], dtype=torch.int64), dst=0)
        if payload:
            dist.send(torch.frombuffer(bytearray(payload), dtype=torch.uint8),
                      dst=0)
        return None
    out = [payload]
    for rank in range(1, n):
        length = torch.zeros(1, dtype=torch.int64)
        dist.recv(length, src=rank)
        buf = torch.empty(int(length), dtype=torch.uint8)
        if len(buf):
            dist.recv(buf, src=rank)
        out.append(buf.numpy().tobytes())
    return out


def _pack_sections(lf_secs, hf_secs, freqs: dict) -> bytes:
    """Length-prefixed binary framing for the cross-process section
    gather (no pickle: the one payload that crosses machine boundaries
    must not be a code-execution vector, even between trusted peers).

    Layout (little-endian):
      u32 magic 'HSEC', u32 n_lf, u32 n_hf, u32 n_freq
      n_lf  x  (i64 lfid, u32 tail_val, u32 tail_bits, u64 len, bytes)
      n_hf  x  (i64 lfid, i64 j, u32 tail_val, u32 tail_bits,
                u64 len, bytes)
      n_freq x (i64 cluster, u64 count, count x u32)"""
    parts = [struct.pack("<4sIII", b"HSEC", len(lf_secs), len(hf_secs),
                         len(freqs))]
    for lfid, (data, tv, tb) in lf_secs:
        parts.append(struct.pack("<qIIQ", lfid, tv, tb, len(data)))
        parts.append(data)
    for (lfid, j), (data, tv, tb) in hf_secs:
        parts.append(struct.pack("<qqIIQ", lfid, j, tv, tb, len(data)))
        parts.append(data)
    for c, f in freqs.items():
        a = np.ascontiguousarray(f, np.uint32)
        parts.append(struct.pack("<qQ", c, a.size))
        parts.append(a.tobytes())
    return b"".join(parts)


def _unpack_sections(blob: bytes):
    """Inverse of _pack_sections -> (lf dict, hf dict, freqs dict);
    raises ValueError on malformed framing (lengths validated against
    the buffer before every slice)."""
    mv = memoryview(blob)
    pos = 0

    def take(fmt):
        nonlocal pos
        size = struct.calcsize(fmt)
        if pos + size > len(mv):
            raise ValueError("truncated section payload")
        vals = struct.unpack_from(fmt, mv, pos)
        pos += size
        return vals

    def take_bytes(n):
        nonlocal pos
        if n > len(mv) - pos:
            raise ValueError("section length past payload end")
        b = bytes(mv[pos:pos + n])
        pos += n
        return b

    magic, n_lf, n_hf, n_freq = take("<4sIII")
    if magic != b"HSEC":
        raise ValueError("bad section payload magic")
    lf = {}
    for _ in range(n_lf):
        lfid, tv, tb, ln = take("<qIIQ")
        lf[lfid] = (take_bytes(ln), tv, tb)
    hf = {}
    for _ in range(n_hf):
        lfid, j, tv, tb, ln = take("<qqIIQ")
        hf[(lfid, j)] = (take_bytes(ln), tv, tb)
    freqs = {}
    for _ in range(n_freq):
        c, count = take("<qQ")
        freqs[c] = np.frombuffer(take_bytes(count * 4), np.uint32)
    if pos != len(mv):
        raise ValueError("trailing bytes in section payload")
    return lf, hf, freqs


def _assign_presets(num_presets: int, n_proc: int, pid: int) -> range:
    """Contiguous preset partition: every histogram preset (and hence
    every LF group of that preset) lives wholly on one process, so HF
    sections and cluster frequencies never need a cross-process symbol
    exchange -- only the final byte gather."""
    per = (num_presets + n_proc - 1) // n_proc
    return range(min(pid * per, num_presets),
                 min((pid + 1) * per, num_presets))


def encode_image_multihost(image, *, linear_light: bool = False,
                           sample_fmt: str = "uint8",
                           spool_dir: Optional[str] = None,
                           attempts: int = 3, device="cuda",
                           fused_front: Optional[bool] = None,
                           stats=None) -> Optional[bytes]:
    """One-frame encode with LF groups spread over the processes of the
    group (`initialize`; one process when there is none).

    Every process passes the full image (an array, a memory-mapped view
    or any object that slices like one: only its own LF groups' pixels
    are read) and runs the packed pipeline (encoder._TorchDispatch) on
    its preset-aligned slice of LF groups, on `device`: "cuda" means
    card `rank % device_count`, and raises without a card; the CPU is
    used only when named.  Each process serializes its LF and HF
    sections with the fixed-las streaming scheme (StreamingHFStream),
    with a transport codec of its own (cold: neither read from nor
    written to the process's warm cache) and an EncodeStats of its own
    unless `stats` is given.  Process 0 gathers sections and cluster
    frequencies (gather_bytes_to_host0) and assembles headers and TOC;
    other processes return None.  Each LF group step is wrapped in
    `with_retry`: a checksum mismatch raises before any symbol is fed.

    The output equals the single-process
    `Encoder(meta, device=..., streaming=True)`'s for the same image
    and front (fused_front: None follows HYDRIUM_PALLAS)."""
    from ..config import ImageMetadata
    from ..device import resolve_device
    from ..encoder import _TorchDispatch
    from ..jxl import headers, native
    from ..jxl.frame import (FrameSections, StreamingHFStream,
                             new_bitwriter, one_frame_geometry,
                             write_frame_header, write_hf_global_fixed_las,
                             write_lf_global, write_lf_group)
    from ..jxl.tokcode import TokenCodec
    from ..ops.front import FrontEnd
    from ..ops.frontend import default_fused
    from ..utils.stats import EncodeStats

    if not native.available():
        raise RuntimeError("multi-process encode needs the native plane "
                           "(csrc/host/serializer.cc)")
    n_proc = process_count()
    pid = process_index()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", pid % torch.cuda.device_count())
    h, w = image.shape[:2]
    meta = ImageMetadata(width=w, height=h, linear_light=linear_light)
    geo = one_frame_geometry(w, h)
    lfgs = geo.lf_groups
    n = len(lfgs)
    geo.lfg_arrival.extend(range(n))
    num_presets = geo.num_presets
    lpp = geo.lfg_per_preset
    my_presets = _assign_presets(num_presets, n_proc, pid)
    my_lfids = [i for p in my_presets
                for i in range(p * lpp, min((p + 1) * lpp, n))]

    hf = StreamingHFStream(num_presets, geo.preset_lfg_counts,
                           FrameSections(True, spool_dir))
    codec = TokenCodec()
    front = FrontEnd.from_tables().to(dev)
    fused = default_fused() if fused_front is None else bool(fused_front)
    stats = EncodeStats() if stats is None else stats

    lf_secs = []     # (lfid, (bytes, tail_val, tail_bits))

    def one_lfg(lfid: int):
        lfg = lfgs[lfid]
        preset = lfid // lpp
        with stats.stage("dispatch"):
            pixels = image[lfg.y * 2048:lfg.y * 2048 + lfg.height,
                           lfg.x * 2048:lfg.x * 2048 + lfg.width]
            handle = _TorchDispatch(pixels, sample_fmt, linear_light, lfg,
                                    preset, hf, codec, front, dev, stats,
                                    fused=fused)
        with stats.stage("pipeline+transfer"):
            return handle.drain(), preset

    step = with_retry(one_lfg, attempts=attempts)
    for lfid in my_lfids:
        (lf_q, lf_res), preset = step(lfid)
        with stats.stage("lf_sections"):
            bw = new_bitwriter()
            write_lf_group(bw, lf_q, lf_res)
            lf_secs.append((lfid, bw.export_raw()))
        with stats.stage("ans_encode"):
            encoded = hf.finish_lfg(preset)
        stats.count("ans_symbols", encoded)
    hf.encode_group_sections()   # asserts all local presets flushed

    # an HF section's key ends in (arrival, j); this process's LF groups
    # arrived in my_lfids order
    hf_secs = [((my_lfids[key[-2]], key[-1]), raw)
               for key, raw in hf.sections.items()]
    n_groups = sum(lfgs[lfid].group_count for lfid in my_lfids)
    if len(hf_secs) != n_groups:
        raise RuntimeError(f"{len(hf_secs)} HF sections for "
                           f"{n_groups} groups")
    my_freqs = hf.frequencies()
    hf.sections.close()   # sections read whole above; drop the spool now

    payload = _pack_sections(lf_secs, hf_secs, my_freqs)
    del lf_secs, hf_secs
    gathered = gather_bytes_to_host0(payload)
    del payload
    if gathered is None:
        return None

    # -- process 0: assemble ------------------------------------------------
    all_lf: dict = {}
    all_hf: dict = {}
    freqs: dict = {}
    while gathered:
        # each blob is dropped once its sections are out
        part_lf, part_hf, part_freqs = _unpack_sections(gathered.pop(0))
        all_lf.update(part_lf)
        all_hf.update(part_hf)
        freqs.update(part_freqs)
    if len(all_lf) != n:
        raise RuntimeError(f"missing LF sections: have {sorted(all_lf)}")

    main = new_bitwriter()
    headers.write_image_header(main, w, h, meta.level10)
    write_frame_header(main, geo, True)
    frame = FrameSections(geo.toc_size > 1)
    frame.write(write_lf_global)
    for lfid in range(n):
        frame.add(all_lf.pop(lfid))
    frame.write(write_hf_global_fixed_las, hf.cluster_map, num_presets,
                freqs, geo.num_frame_groups, StreamingHFStream.FIXED_LAS)
    for key in sorted(all_hf):
        frame.add(all_hf.pop(key))
    frame.write_toc(main)
    # the file joined once: process 0 holds the sections and the file only
    return b"".join([main.finalize(), *frame.chunks()])


def main(argv=None) -> int:
    """One process of a multi-process encode; prints one JSON line
    (rank, wall seconds, the encode's counters and stage seconds)."""
    from ..utils.stats import EncodeStats

    p = argparse.ArgumentParser(
        prog="python -m hydrium_tpu_torch.parallel.multihost",
        description="One process of a multi-process one-frame encode.")
    p.add_argument("coordinator", help="host:port where rank 0 listens")
    p.add_argument("num_processes", type=int)
    p.add_argument("process_id", type=int)
    p.add_argument("image", help=".npy [H, W, 3] u8, u16 or f32 array")
    p.add_argument("out", help=".jxl that process 0 writes")
    p.add_argument("--device", default="cuda",
                   help="cuda (card rank %% count, the default) or cpu")
    a = p.parse_args(argv)
    image = np.load(a.image, mmap_mode="r")
    fmt = {np.dtype(np.uint8): "uint8", np.dtype(np.uint16): "uint16"}.get(
        image.dtype, "float32")
    initialize(a.coordinator, a.num_processes, a.process_id)
    try:
        stats = EncodeStats()
        t0 = time.perf_counter()
        data = encode_image_multihost(image, sample_fmt=fmt,
                                      device=a.device, stats=stats)
        wall = time.perf_counter() - t0
    finally:
        shutdown()
    if data is not None:
        with open(a.out, "wb") as f:
            f.write(data)
    print(json.dumps({"rank": a.process_id, "wall_s": wall,
                      "counters": dict(stats.counters),
                      "stages_s": dict(stats.stage_seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
