"""The frozen kernel byte arithmetic reproduces the bounds that PERF.md
section 6 gives per dispatch shape (bytes over 3.35 TB/s, in ms)."""

import pytest

from jxlbench import kernels

HBM = 3.35e12
# shape: (n rows, pixels read, 256^2 groups); the edge tile as PERF.md
# measured it: a 3072-row buffer and a 128-row upload
SHAPES = {"lfg": (196608, 2048 * 2048, 64), "chunk": (49152, 16 * 65536, 16),
          "edge": (3072, 128 * 256, 1)}
BOUND_MS = {("transport_prep", "lfg"): 0.0904,
            ("transport_prep", "chunk"): 0.0226,
            ("transport_prep", "edge"): 0.0014,
            ("chunk_pack", "lfg"): 0.0716,
            ("chunk_pack", "chunk"): 0.0179,
            ("chunk_pack", "edge"): 0.00112,
            ("frontend_tokens", "lfg"): 0.0343,
            ("frontend_tokens", "chunk"): 0.0086,
            ("frontend_tokens", "edge"): 0.00051}


@pytest.mark.parametrize("kernel,shape", sorted(BOUND_MS))
def test_bytes_agree_with_the_documented_bounds(kernel, shape):
    ms = kernels.BYTES[kernel](*SHAPES[shape]) / HBM * 1e3
    assert ms == pytest.approx(BOUND_MS[(kernel, shape)], rel=0.03)


def test_a_4k_image_counts_the_same_blocks_both_ways():
    one = kernels.units(2160, 3840, -1)
    tiled = kernels.units(2160, 3840, 256)
    assert len(one) == 4 and len(tiled) == 135
    for i in range(3):
        assert sum(u[i] for u in one) == sum(u[i] for u in tiled)
    assert sum(u[0] for u in one) == 3 * 270 * 480
