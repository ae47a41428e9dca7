"""JPEG XL VarDCT format constants (the port's copy of
hydrium_tpu/ops/tables.py; tests/test_torch_isolation.py holds the two
equal).

These are *data* required for format/rate parity with the reference
encoder (and ultimately with the JPEG XL spec's expectations):

- COSINE_LUT: the 1-D DCT-II basis rows at the exact float32 literals the
  reference uses (encoder.c:32-40); bit-parity of quantized coefficients
  requires the same rounded constants, not analytically exact ones.
- Zig-zag coefficient order for 8x8 blocks (encoder.c:42-51).  hydrium
  stores block DCT output transposed (encoder.c:660-663), so the
  coefficient emitted at zig-zag index j is F[ky=order[j].x][kx=order[j].y]
  of the standard (ky, kx) DCT layout; ZIGZAG_KY/ZIGZAG_KX bake that in.
- HF coefficient context tables (encoder.c:53-66).
- HF quantization weights, per channel X/Y/B by zig-zag index
  (encoder.c:74-93) and the fixed quality multiplier hf_mult=5.
"""

import numpy as np

COSINE_LUT = np.array(
    [
        [0.17338, 0.146984, 0.0982119, 0.0344874,
         -0.0344874, -0.0982119, -0.146984, -0.17338],
        [0.16332, 0.0676495, -0.0676495, -0.16332,
         -0.16332, -0.0676495, 0.0676495, 0.16332],
        [0.146984, -0.0344874, -0.17338, -0.0982119,
         0.0982119, 0.17338, 0.0344874, -0.146984],
        [0.125, -0.125, -0.125, 0.125, 0.125, -0.125, -0.125, 0.125],
        [0.0982119, -0.17338, 0.0344874, 0.146984,
         -0.146984, -0.0344874, 0.17338, -0.0982119],
        [0.0676495, -0.16332, 0.16332, -0.0676495,
         -0.0676495, 0.16332, -0.16332, 0.0676495],
        [0.0344874, -0.0982119, 0.146984, -0.17338,
         0.17338, -0.146984, 0.0982119, -0.0344874],
    ],
    dtype=np.float32,
)

# (x, y) pairs of the 8x8 natural (zig-zag) order.
NATURAL_ORDER_XY = np.array(
    [
        (0, 0), (1, 0), (0, 1), (0, 2), (1, 1), (2, 0), (3, 0), (2, 1),
        (1, 2), (0, 3), (0, 4), (1, 3), (2, 2), (3, 1), (4, 0), (5, 0),
        (4, 1), (3, 2), (2, 3), (1, 4), (0, 5), (0, 6), (1, 5), (2, 4),
        (3, 3), (4, 2), (5, 1), (6, 0), (7, 0), (6, 1), (5, 2), (4, 3),
        (3, 4), (2, 5), (1, 6), (0, 7), (1, 7), (2, 6), (3, 5), (4, 4),
        (5, 3), (6, 2), (7, 1), (7, 2), (6, 3), (5, 4), (4, 5), (3, 6),
        (2, 7), (3, 7), (4, 6), (5, 5), (6, 4), (7, 3), (7, 4), (6, 5),
        (5, 6), (4, 7), (5, 7), (6, 6), (7, 5), (7, 6), (6, 7), (7, 7),
    ],
    dtype=np.int32,
)

# Coefficient emitted at zig-zag index j reads the stored (transposed)
# position, i.e. F[ky=x_j][kx=y_j] in standard frequency layout.
ZIGZAG_KY = NATURAL_ORDER_XY[:, 0]
ZIGZAG_KX = NATURAL_ORDER_XY[:, 1]

COEFF_FREQ_CONTEXT = np.array(
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
     15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
     23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
     27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30],
    dtype=np.int32,
)

COEFF_NUM_NONZERO_CONTEXT = np.array(
    [0, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123, 152,
     152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180, 180, 180,
     180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206, 206, 206, 206,
     206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
     206, 206, 206, 206, 206, 206, 206, 206],
    dtype=np.int32,
)

HF_QUANT_WEIGHTS = np.array(
    [
        [1969, 1969, 1969, 1962, 1969, 1962, 1655, 1885, 1885, 1655, 1397,
         1610, 1704, 1610, 1397, 1178, 1368, 1494, 1494, 1368, 1178, 994,
         1159, 1289, 1340, 1289, 1159, 994, 839, 980, 1104, 1178, 1178,
         1104, 980, 839, 829, 941, 1023, 1054, 1023, 941, 829, 800, 881,
         928, 928, 881, 800, 755, 809, 829, 809, 755, 663, 731, 731, 663,
         491, 524, 491, 349, 349, 239],
        [280, 280, 280, 279, 280, 279, 245, 271, 271, 245, 214, 239, 250,
         239, 214, 188, 211, 226, 226, 211, 188, 164, 185, 201, 207, 201,
         185, 164, 144, 163, 178, 188, 188, 178, 163, 144, 143, 157, 168,
         172, 168, 157, 143, 139, 150, 156, 156, 150, 139, 133, 140, 143,
         140, 133, 125, 129, 129, 125, 116, 118, 116, 107, 107, 98],
        [256, 147, 147, 85, 117, 85, 60, 78, 78, 60, 43, 56, 63, 56, 43,
         43, 43, 48, 48, 43, 43, 42, 43, 43, 43, 43, 43, 42, 29, 41, 43,
         43, 43, 43, 41, 29, 29, 37, 43, 43, 43, 37, 29, 27, 33, 36, 36,
         33, 27, 24, 27, 29, 27, 24, 20, 22, 22, 20, 15, 16, 15, 10, 10,
         7],
    ],
    dtype=np.int32,
)

HF_MULT = 5
LF_SHIFT = np.array([8192.0, 1024.0, 512.0], dtype=np.float32)

# Number of HF contexts per histogram preset: 111 nonzero-count contexts
# (3 block contexts x 37 predicted-count buckets) + 3 x 458 coefficient
# contexts (encoder.c:715,:724).
CONTEXTS_PER_PRESET = 1485
NZ_CONTEXTS = 111
COEFF_CONTEXTS_PER_BLOCK_CTX = 458


def hf_cluster_map(num_presets: int) -> np.ndarray:
    """Context->cluster map for the HF ANS stream (encoder.c:855-901).

    Chooses 9/3/2/1 clusters per preset so the total stays <= 256."""
    cm = np.zeros(CONTEXTS_PER_PRESET * num_presets, dtype=np.uint8)
    j = np.arange(CONTEXTS_PER_PRESET)
    if num_presets * 9 <= 256:
        base = np.where(j < NZ_CONTEXTS, j % 3, 3 + (j - NZ_CONTEXTS) % 6)
        per = 9
    elif num_presets * 3 <= 256:
        base = np.where(j < NZ_CONTEXTS, 0, 1 + (j - NZ_CONTEXTS) % 2)
        per = 3
    elif num_presets * 2 <= 256:
        base = np.where(j < NZ_CONTEXTS, 0, 1)
        per = 2
    else:
        base = np.zeros_like(j)
        per = 1
    for p in range(num_presets):
        cm[p * CONTEXTS_PER_PRESET:(p + 1) * CONTEXTS_PER_PRESET] = (
            per * p + base)
    return cm
