// Fused front: pixels of an LF-group buffer -> quantized HF coefficients
// and LF (DC) ints in one pass.  Per 8x8 block, in this order: sample
// scaling, the sRGB cubic linearisation (unless linear light), the LMS
// mix and biased cube root (XYB), the 8x8 DCT-II with the reference's
// rounded basis, LF quant (DC * LF_SHIFT, truncated), and the zig-zag HF
// quant in emission order Y, X, B (one multiply by the weight
// premultiplied with HF_MULT, truncated, dead zone |q| < 2 -> 0, slot 0
// -> 0).  Pixels outside the buffer (uh, uw) or the true extent
// (height, width) read as zero before any of that, so the pad and the
// mask of the XLA caller are fused in.
//
// Replaces the TPU kernel hydrium_tpu/ops/pallas/frontend.py::
// frontend_groups (_kernel).  That kernel took channel-major groups,
// did each plane's DCT as two [256, 256] MXU products with the
// (ky, by) rearrangement folded into the constant, picked 32 columns
// with one-hot matmuls and wrote a tile-major [3, 64, 32, 32] layout
// that XLA then transposed.  All of that is Mosaic's shape; none of it
// carries over.  Here the DCT is 16 multiply-adds per sample in
// registers, and the output is written straight in the flat [N, 64]
// emission layout the tokenizer reads, so nothing is transposed after.
//
// Bound on the card: device-memory bytes.  A 2048^2 LF group reads
// 12.6 MB of u8 and writes 50.3 MB of q plus 0.8 MB of dc: ~19 us at
// 3.35 TB/s.  The arithmetic (3 cube roots and 48 multiply-adds per
// pixel) is a few us.  Design: one block per (group, row of 32 blocks),
// 256 threads, thread t owning column t of the 8 x 256 strip.  The strip
// goes to shared memory as XYB (3 x 8 x 256 f32, 24 KB).  The row pass
// reads its block's 8 samples from shared memory; its 8 outputs are the
// inputs of the thread's own column pass, so that pass runs in
// registers.  The coefficients go back to the same shared buffer, and
// the block writes its 96 block-channel rows of 64 ints (24 KB,
// contiguous in the output) with consecutive threads on consecutive
// ints.  The tables (basis, weights, LF shifts, zig-zag) come from the
// wrapper, so they have one source with the plain twin, and are staged
// in shared memory: the row pass reads 8 different basis rows per warp,
// which constant memory would serialise.
//
// Float results differ from the plain twin by summation order, FMA
// contraction and cbrtf against pow(x, 1/3); a few truncations per
// million flip.  Plain twin: hydrium_tpu_torch/ops/frontend.py
// frontend_lfg_plain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 256;                 // group width = threads per block
constexpr int kTab = 64 + 192 + 3;      // basis | weights | LF shifts

__device__ __forceinline__ float linearize(float x) {
  const float lo = 0.07739938080495357f * x;
  const float hi = 0.003094300919832f +
                   x * (-0.009982599f + x * (0.72007737769f + 0.2852804880f * x));
  return x <= 0.0404482362771082f ? lo : hi;
}

__device__ __forceinline__ float bias_cbrt(float v) {
  return cbrtf(v + 0.0037930732552754493f) - 0.155954f;
}

template <typename T>
__global__ void __launch_bounds__(kW)
frontend_kernel(const T* __restrict__ px, int uh, int uw, int height, int width,
                int gcx, float scale, int linear_light,
                const float* __restrict__ ftab, const int32_t* __restrict__ zz,
                int32_t* __restrict__ q, int32_t* __restrict__ dc) {
  __shared__ float s_tab[kTab];
  __shared__ int s_zz[64];
  __shared__ float s_plane[3][8][kW];   // XYB strip, then its coefficients
  const float* s_basis = s_tab;         // [8 k][8 x]
  const float* s_wq = s_tab + 64;       // [3 emission channel][64 zig-zag]
  const float* s_lf = s_tab + 256;      // [3 storage channel]

  const int t = threadIdx.x;
  for (int i = t; i < kTab; i += kW) s_tab[i] = ftab[i];
  if (t < 64) s_zz[t] = zz[t];

  const int g = blockIdx.x >> 5, by = blockIdx.x & 31;
  const int gy = g / gcx, gx = g - gy * gcx;
  const int col = gx * kW + t;
  const int row0 = gy * kW + by * 8;
  const int hmax = min(uh, height), wmax = min(uw, width);

  for (int y = 0; y < 8; ++y) {
    const int row = row0 + y;
    float r = 0.f, gr = 0.f, b = 0.f;
    if (row < hmax && col < wmax) {
      const T* p = px + ((long long)row * uw + col) * 3;
      r = (float)p[0] * scale;
      gr = (float)p[1] * scale;
      b = (float)p[2] * scale;
    }
    if (!linear_light) {
      r = linearize(r);
      gr = linearize(gr);
      b = linearize(b);
    }
    const float l = bias_cbrt(0.3f * r + 0.622f * gr + 0.078f * b);
    const float m = bias_cbrt(0.23f * r + 0.692f * gr + 0.078f * b);
    const float s = bias_cbrt(0.243423f * r + 0.204767f * gr + 0.55181f * b);
    const float yy = (l + m) * 0.5f;
    s_plane[0][y][t] = yy - m;          // X
    s_plane[1][y][t] = yy;              // Y
    s_plane[2][y][t] = s - yy;          // B
  }
  __syncthreads();

  // thread t: block bx = t / 8, horizontal frequency kx = t % 8
  const int x0 = t & ~7, kx = t & 7;
  float f[3][8];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rowt[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) acc += s_basis[kx * 8 + x] * s_plane[c][y][x0 + x];
      rowt[y] = acc;
    }
#pragma unroll
    for (int ky = 0; ky < 8; ++ky) {
      float acc = 0.f;
#pragma unroll
      for (int y = 0; y < 8; ++y) acc += s_basis[ky * 8 + y] * rowt[y];
      f[c][ky] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int ky = 0; ky < 8; ++ky) s_plane[c][ky][t] = f[c][ky];
  __syncthreads();

  // LF: dc[vy, vx, c] over the buffer's varblock grid
  if (t < 96) {
    const int bx = t / 3, c = t - bx * 3;
    const long long vy = gy * 32 + by, vx = gx * 32 + bx;
    dc[(vy * (gcx * 32) + vx) * 3 + c] =
        __float2int_rz(s_plane[c][0][bx * 8] * s_lf[c]);
  }

  // HF: this block-row's 96 rows of 64 ints, contiguous in q
  int32_t* qb = q + (long long)(g * 1024 + by * 32) * 3 * 64;
  for (int o = t; o < 32 * 3 * 64; o += kW) {
    const int bx = o / 192, rem = o - bx * 192;
    const int ce = rem >> 6, j = rem & 63;
    const int c = ce == 0 ? 1 : (ce == 1 ? 0 : 2);   // emission -> storage
    const int p = s_zz[j];
    int v = __float2int_rz(s_plane[c][p >> 3][bx * 8 + (p & 7)] * s_wq[rem]);
    // dead zone |v| < 2; the twin's abs() leaves INT_MIN negative, so a
    // saturated INT_MIN goes to 0 there too
    if (j == 0 || (v > -2 && v < 2) || v == INT32_MIN) v = 0;
    qb[o] = v;
  }
}

template <typename T>
void launch(const void* px, int uh, int uw, int height, int width, int gcy,
            int gcx, float scale, int linear_light, const void* ftab,
            const void* zz, void* q, void* dc, cudaStream_t stream) {
  frontend_kernel<T><<<(unsigned)(gcy * gcx * 32), kW, 0, stream>>>(
      (const T*)px, uh, uw, height, width, gcx, scale, linear_light,
      (const float*)ftab, (const int32_t*)zz, (int32_t*)q, (int32_t*)dc);
}

}  // namespace

// kind: 0 u8, 1 u16, 2 f32 samples.  px [uh, uw, 3] contiguous; the buffer
// is gcy x gcx groups of 256^2.  q [gcy*gcx*3072, 64] i32, dc
// [gcy*32, gcx*32, 3] i32.  ftab f32 [259] = basis [8,8] | weights x
// HF_MULT [3,64] emission order | LF_SHIFT [3]; zz i32 [64] = ky*8 + kx.
extern "C" int hyd_frontend(const void* px, int kind, int uh, int uw, int height,
                            int width, int gcy, int gcx, float scale,
                            int linear_light, const void* ftab, const void* zz,
                            void* q, void* dc, void* stream) {
  if (gcy < 1 || gcx < 1 || uh < 0 || uw < 0 || uh > gcy * kW || uw > gcx * kW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      launch<uint8_t>(px, uh, uw, height, width, gcy, gcx, scale, linear_light,
                      ftab, zz, q, dc, st);
      break;
    case 1:
      launch<uint16_t>(px, uh, uw, height, width, gcy, gcx, scale, linear_light,
                       ftab, zz, q, dc, st);
      break;
    case 2:
      launch<float>(px, uh, uw, height, width, gcy, gcx, scale, linear_light,
                    ftab, zz, q, dc, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
