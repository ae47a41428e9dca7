// Fused front: pixels of an LF-group buffer -> quantized HF coefficients
// and LF (DC) ints in one pass, or (the tokens epilogue) straight to the
// tokenizer's five [N, 64] streams.  Per 8x8 block, in this order: sample
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
// that XLA then transposed, and XLA's tokenizer read q back.  None of
// that carries over.  Here the DCT is 16 multiply-adds per sample in
// registers, and the output is the flat [N, 64] emission layout.
//
// One kernel, one prologue, two epilogues chosen by a runtime `mode`, so
// both give the same q bit for bit (the same machine code computes it):
//   mode 0 (q/dc): q i32 [N, 64] and dc; frontend_groups' function.
//   mode 1 (tokens): in place of q, what ops/front.py::tokenize_flat and
//     front_tokens' extent mask make of it: tokens u16, clusters u8,
//     residues u32, residue widths u8 (all [N, 64]) and valid_len i32
//     [N], zero outside the true varblock extent; plus dc.
//
// Bound on the card: device-memory bytes.  A 2048^2 LF group (G = 64)
// reads 12.6 MB of u8; mode 0 writes 50.3 MB of q and 0.8 MB of dc
// (63.7 MB, 19.0 us at 3.35 TB/s); mode 1 writes 8 bytes a slot (100.7
// MB) plus valid_len and dc (114.9 MB, 34.3 us), and keeps the ~40
// plain passes of the tokenizer over q out of device memory.  Design:
// - a block of 256 threads takes strips of 8 rows x 256 columns of one
//   group, thread t owning column t, and walks strips with a stride of
//   the grid (as many blocks as fit on the card at once), so the tables
//   are staged once per block.  Narrower strips for small buffers were
//   tried: 4% faster on an edge tile, 5% slower at G = 8 (PERF.md);
// - the next strip's raw rows are fetched with 16-byte cp.async into the
//   other half of a double buffer while this strip computes; rows that
//   are not 16-byte aligned (any contiguous [uh, uw, 3] upload is taken)
//   are copied byte by byte into the same buffer;
// - u8 samples are scaled and linearized through a 256-entry table;
// - XYB goes to shared memory; the row pass reads it, the column pass
//   runs in registers; each thread quantizes its own coefficients and
//   stores each at its emission slot (inverse zig-zag table) in a
//   per-block stage padded to 196 ints, so the epilogues read rows of
//   64 slots without bank conflicts;
// - mode 0 writes the strip's contiguous q rows with 16-byte stores;
//   mode 1 gives each row of 64 slots to one warp, lane l taking slots
//   2l and 2l+1: two ballots give the row's nonzero bits, popcounts the
//   nonzero count and the remaining count, clz the last nonzero slot
//   and the hybrid-uint exponent; every store of a warp is one
//   contiguous run (128 B of tokens, 64 B of clusters, 256 B of
//   residues, 64 B of widths).
// Tensor cores stay out: the DCT stays float32 (TF32 would move
// quantization decisions).  Measured on the H100, the kernel runs at
// ~40% of the byte bound and is held by instruction throughput instead
// (~2,900 SASS instructions per thread and strip of 8 pixels, ~210
// float32 operations a pixel): taking the loads or the stores out moves
// it by under 7%, taking out the cube roots, the DCT or the quantization
// by 12-25% each (PERF.md, Findings).
//
// Float results differ from the plain twin by summation order, FMA
// contraction and cbrtf against pow(x, 1/3); a few truncations per
// million flip.  Plain twins: hydrium_tpu_torch/ops/frontend.py
// frontend_lfg_plain (mode 0) and frontend_tokens_plain (mode 1).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTab = 64 + 192 + 3;      // basis | weights | LF shifts
constexpr int kTabPad = 260;
constexpr int kITab = 64 + 64 + 63;     // inverse zig-zag | cnzc%3 | cfc%3
constexpr int kITabPad = 192;
constexpr int kRS = 196;                // ints per 8x8 block in the q stage
constexpr int kLut = 256;               // u8 samples -> linear light
constexpr int kCols = 256;              // threads a block, columns a strip
constexpr int NBX = kCols / 8;          // 8x8 blocks a strip
constexpr int NWARP = kCols / 32;

struct Args {
  const void* px;
  int uh, uw;                 // the upload
  int hmax, wmax;             // pixels kept: the true extent within it
  int vh, vw;                 // true varblock extent (valid_len mask)
  int gcx, nstrips;
  float scale;
  int linear_light, mode, per;
  const float* ftab;
  const int32_t* itab;
  int32_t* q;
  int32_t* dc;
  const int32_t* presets;
  uint16_t* tokens;
  uint8_t* clusters;
  int32_t* residues;
  uint8_t* rbits;
  int32_t* valid_len;
};

template <typename T>
__host__ __device__ constexpr int raw_row_bytes() {
  return kCols * 3 * (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(kTabPad + kITabPad + kLut) * 4 +
         2 * 8 * raw_row_bytes<T>() + (size_t)NBX * kRS * 4;
}

__device__ __forceinline__ float linearize(float x) {
  const float lo = 0.07739938080495357f * x;
  const float hi = 0.003094300919832f +
                   x * (-0.009982599f + x * (0.72007737769f + 0.2852804880f * x));
  return x <= 0.0404482362771082f ? lo : hi;
}

__device__ __forceinline__ float bias_cbrt(float v) {
  return cbrtf(v + 0.0037930732552754493f) - 0.155954f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Strip {
  int g, gy, gx, by, row0, col0;
};

__device__ __forceinline__ Strip strip_of(int s, int gcx) {
  Strip st;
  st.g = s >> 5;
  st.by = s & 31;
  st.gy = st.g / gcx;
  st.gx = st.g - st.gy * gcx;
  st.row0 = st.gy * 256 + st.by * 8;
  st.col0 = st.gx * 256;
  return st;
}

// Fetch the strip's kept samples (rows < hmax, columns < wmax) into dst,
// [8 rows][raw_row_bytes]; the rest of dst is left as it is (masked on
// read).  16-byte pieces of aligned rows go by cp.async, others by bytes.
template <typename T>
__device__ __forceinline__ void load_strip(const Args& a, const Strip& st,
                                           unsigned char* dst) {
  constexpr int RB = raw_row_bytes<T>();
  const int ncols = min(kCols, a.wmax - st.col0);
  const int nrows = min(8, a.hmax - st.row0);
  if (ncols <= 0 || nrows <= 0) return;
  const int n = ncols * 3 * (int)sizeof(T);
  const int pieces = (n + 15) >> 4;
  const unsigned char* base = (const unsigned char*)a.px;
  for (int k = threadIdx.x; k < nrows * pieces; k += kCols) {
    const int y = k / pieces, i = k - y * pieces;
    const unsigned char* src =
        base + ((long long)(st.row0 + y) * a.uw + st.col0) * 3 * sizeof(T) +
        i * 16;
    unsigned char* d = dst + y * RB + i * 16;
    const int len = min(16, n - i * 16);
    if (len == 16 && ((uintptr_t)src & 15) == 0) {
      cp_async16(d, src);
    } else {
      for (int b = 0; b < len; ++b) d[b] = src[b];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCols)
frontend_kernel(const Args a) {
  constexpr int RB = raw_row_bytes<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tab = (float*)smem;                        // kTabPad
  int* s_itab = (int*)(smem + kTabPad * 4);           // kITabPad
  float* s_lut = (float*)(smem + (kTabPad + kITabPad) * 4);   // kLut
  unsigned char* s_raw = smem + (kTabPad + kITabPad + kLut) * 4;  // 2x8xRB
  float* s_plane = (float*)(s_raw + 2 * 8 * RB);      // XYB [3][8][kCols]
  int* s_q = (int*)s_plane;                           // then q [NBX][kRS]
  const float* s_basis = s_tab;          // [8 k][8 x]
  const float* s_wq = s_tab + 64;        // [3 emission channel][64 zig-zag]
  const float* s_lf = s_tab + 256;       // [3 storage channel]
  const int* s_izz = s_itab;             // ky*8+kx -> zig-zag slot
  const int* s_cnz = s_itab + 64;        // COEFF_NUM_NONZERO_CONTEXT % 3
  const int* s_cfc = s_itab + 128;       // COEFF_FREQ_CONTEXT[1:] % 3

  const int t = threadIdx.x;
  for (int i = t; i < kTab; i += kCols) s_tab[i] = a.ftab[i];
  for (int i = t; i < kITab; i += kCols) s_itab[i] = a.itab[i];
  if constexpr (sizeof(T) == 1) {
    // the 256 u8 samples, scaled (and linearized) once per block
    for (int i = t; i < kLut; i += kCols) {
      const float v = (float)i * a.scale;
      s_lut[i] = a.linear_light ? v : linearize(v);
    }
  }

  int s = blockIdx.x;
  if (s < a.nstrips) load_strip<T>(a, strip_of(s, a.gcx), s_raw);
  cp_async_commit();
  __syncthreads();                       // tables

  const int x0 = t & ~7, kx = t & 7, bx = t >> 3;
  const int lane = t & 31;
  // the tokens epilogue's frequency contexts of this lane's slots 2l, 2l+1
  const int cfc0 = lane ? s_cfc[2 * lane - 1] : 0, cfc1 = s_cfc[2 * lane];
  float bk[8];                           // basis row kx for the row pass
#pragma unroll
  for (int x = 0; x < 8; ++x) bk[x] = s_basis[kx * 8 + x];

  for (int it = 0; s < a.nstrips; s += gridDim.x, ++it) {
    const Strip st = strip_of(s, a.gcx);
    const int nxt = s + gridDim.x;
    if (nxt < a.nstrips)
      load_strip<T>(a, strip_of(nxt, a.gcx), s_raw + ((it + 1) & 1) * 8 * RB);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    // XYB of column t, rows 0..7
    const unsigned char* raw = s_raw + (it & 1) * 8 * RB;
    const int col = st.col0 + t;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const bool keep = st.row0 + y < a.hmax && col < a.wmax;
      const T* p = (const T*)(raw + y * RB) + t * 3;
      float r, gr, b;    // linearize(0) is 0: a masked sample reads 0
      if constexpr (sizeof(T) == 1) {
        r = keep ? s_lut[p[0]] : 0.f;
        gr = keep ? s_lut[p[1]] : 0.f;
        b = keep ? s_lut[p[2]] : 0.f;
      } else {
        r = keep ? (float)p[0] * a.scale : 0.f;
        gr = keep ? (float)p[1] * a.scale : 0.f;
        b = keep ? (float)p[2] * a.scale : 0.f;
        if (!a.linear_light) {
          r = linearize(r);
          gr = linearize(gr);
          b = linearize(b);
        }
      }
      const float l = bias_cbrt(0.3f * r + 0.622f * gr + 0.078f * b);
      const float m = bias_cbrt(0.23f * r + 0.692f * gr + 0.078f * b);
      const float sg = bias_cbrt(0.243423f * r + 0.204767f * gr + 0.55181f * b);
      const float yy = (l + m) * 0.5f;
      s_plane[(0 * 8 + y) * kCols + t] = yy - m;     // X
      s_plane[(1 * 8 + y) * kCols + t] = yy;         // Y
      s_plane[(2 * 8 + y) * kCols + t] = sg - yy;    // B
    }
    __syncthreads();

    // thread t: block bx = t / 8, horizontal frequency kx = t % 8
    float f[3][8];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float rowt[8];
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x)
          acc += bk[x] * s_plane[(c * 8 + y) * kCols + x0 + x];
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

    // quantize this thread's coefficients into their emission slots
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int ce = c == 1 ? 0 : (c == 0 ? 1 : 2);  // storage -> emission
#pragma unroll
      for (int ky = 0; ky < 8; ++ky) {
        const int j = s_izz[ky * 8 + kx];
        int v = __float2int_rz(f[c][ky] * s_wq[ce * 64 + j]);
        // dead zone |v| < 2; the twin's abs() leaves INT_MIN negative, so
        // a saturated INT_MIN goes to 0 there too
        if (j == 0 || (v > -2 && v < 2) || v == INT_MIN) v = 0;
        s_q[bx * kRS + ce * 64 + j] = v;
      }
    }
    // LF: dc[vy, vx, c] over the buffer's varblock grid
    const int vy = st.gy * 32 + st.by;
    const int vx0 = st.gx * 32;
    if (kx == 0) {
      int32_t* d = a.dc + ((long long)vy * (a.gcx * 32) + vx0 + bx) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = __float2int_rz(f[c][0] * s_lf[c]);
    }
    __syncthreads();

    // the strip's NBX * 3 rows of 64 slots are contiguous in the outputs
    const long long row_base =
        ((long long)st.g * 1024 + st.by * 32) * 3;
    if (a.mode == 0) {
      int4* qb = (int4*)(a.q + row_base * 64);
      for (int i = t; i < NBX * 48; i += kCols) {
        const int b = i / 48, k = i - b * 48;
        qb[i] = *(const int4*)(s_q + b * kRS + k * 4);
      }
    } else {
      const int pbase = a.per * a.presets[st.g];
      const unsigned below = (1u << lane) - 1u;
      for (int r = t >> 5; r < NBX * 3; r += NWARP) {
        const int b = r / 3, ce = r - b * 3;
        const int2 qq = *(const int2*)(s_q + b * kRS + ce * 64 + 2 * lane);
        const unsigned e = __ballot_sync(0xFFFFFFFFu, qq.x != 0);  // 2l
        const unsigned o = __ballot_sync(0xFFFFFFFFu, qq.y != 0);  // 2l+1
        const int nz = __popc(e) + __popc(o);
        const int before = __popc(e & below) + __popc(o & below);
        int last = 0;   // last nonzero slot (slot 0 is always zero)
        if (e) last = 2 * (31 - __clz(e));
        if (o) last = max(last, 2 * (31 - __clz(o)) + 1);
        uint32_t tok2 = 0, cls2 = 0, nb2 = 0;
        int res[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 2 * lane + h;
          const int qv = h ? qq.y : qq.x;
          uint32_t val;
          int cls;
          if (k == 0) {
            val = (uint32_t)nz;
            cls = a.per == 9 ? ce : 0;
          } else {
            val = ((uint32_t)qv << 1) ^ (uint32_t)(qv >> 31);   // zig-zag
            const int remaining = nz - before - (h ? (qq.x != 0) : 0);
            const int prev = k == 1 ? (nz <= 4)
                             : h    ? (qq.x != 0)
                                    : (int)((o >> (lane - 1)) & 1u);
            if (a.per == 9) {
              // remaining is in 0..63; (x % 3) for x <= 6 from a bit table
              const int x = ce + s_cnz[remaining] + (h ? cfc1 : cfc0);
              const int m = (0x924 >> (2 * x)) & 3;
              cls = 3 + 2 * m + prev;
            } else if (a.per == 3) {
              cls = 1 + prev;
            } else {
              cls = a.per == 2 ? 1 : 0;
            }
          }
          // hybrid uint (4, 1, 0) on the int32 view of the value
          uint32_t tok, rv = 0, nb = 0;
          const int sv = (int)val;
          if (sv < 16) {
            tok = val & 0xFFFFu;
          } else {
            const int nbits = 30 - __clz(sv);      // floor(log2) - 1
            rv = val & ((1u << nbits) - 1u);
            nb = (uint32_t)nbits;
            tok = (16u + (((val >> nbits) & 1u) | ((uint32_t)(nbits - 3) << 1)))
                  & 0xFFFFu;
          }
          tok2 |= tok << (16 * h);
          cls2 |= ((uint32_t)(pbase + cls) & 0xFFu) << (8 * h);
          nb2 |= nb << (8 * h);
          res[h] = (int)rv;
        }
        const long long n = row_base + r;
        ((uint32_t*)a.tokens)[n * 32 + lane] = tok2;
        ((uint16_t*)a.clusters)[n * 32 + lane] = (uint16_t)cls2;
        ((int2*)a.residues)[n * 32 + lane] = make_int2(res[0], res[1]);
        ((uint16_t*)a.rbits)[n * 32 + lane] = (uint16_t)nb2;
        if (lane == 0)
          a.valid_len[n] = (vy < a.vh && vx0 + b < a.vw) ? 1 + last : 0;
      }
    }
  }
}

template <typename T>
int launch(Args a, int G, cudaStream_t stream) {
  // set once per instantiation; the occupancy is the same on every card
  // of one architecture
  static const int per_sm = [] {
    const int smem = (int)smem_bytes<T>();
    if (cudaFuncSetAttribute(frontend_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, frontend_kernel<T>, kCols, smem) != cudaSuccess)
      return 0;
    return n;
  }();
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  a.nstrips = G * 32;
  const int grid = a.nstrips < per_sm * sms ? a.nstrips : per_sm * sms;
  frontend_kernel<T><<<grid, kCols, smem_bytes<T>(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 u8, 1 u16, 2 f32 samples.  px [uh, uw, 3] contiguous; the buffer
// is gcy x gcx groups of 256^2; (height, width) the true extent, at most
// the buffer's.  ftab f32 [259] = basis [8,8] | weights x HF_MULT [3,64]
// emission order | LF_SHIFT [3]; itab i32 [191] = inverse zig-zag
// (ky*8+kx -> slot) | COEFF_NUM_NONZERO_CONTEXT % 3 [64] |
// COEFF_FREQ_CONTEXT[1:] % 3 [63].  dc [gcy*32, gcx*32, 3] i32 always.
// mode 0: q [gcy*gcx*3072, 64] i32.  mode 1: presets i32 [gcy*gcx], per
// clusters per preset, tokens u16 / clusters u8 / residues u32 / rbits
// u8 [N, 64] and valid_len i32 [N].
extern "C" int hyd_frontend(const void* px, int kind, int uh, int uw,
                            int height, int width, int gcy, int gcx,
                            float scale, int linear_light, const void* ftab,
                            const void* itab, int mode, void* q, void* dc,
                            const void* presets, int per, void* tokens,
                            void* clusters, void* residues, void* rbits,
                            void* valid_len, void* stream) {
  if (gcy < 1 || gcx < 1 || uh < 0 || uw < 0 || uh > gcy * 256 ||
      uw > gcx * 256 || height < 0 || width < 0 || height > gcy * 256 ||
      width > gcx * 256 || dc == nullptr || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (mode == 0 && q == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == 1 && (presets == nullptr || tokens == nullptr ||
                    clusters == nullptr || residues == nullptr ||
                    rbits == nullptr || valid_len == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.px = px;
  a.uh = uh;
  a.uw = uw;
  a.hmax = uh < height ? uh : height;
  a.wmax = uw < width ? uw : width;
  a.vh = (height + 7) >> 3;
  a.vw = (width + 7) >> 3;
  a.gcx = gcx;
  a.nstrips = 0;
  a.scale = scale;
  a.linear_light = linear_light;
  a.mode = mode;
  a.per = per;
  a.ftab = (const float*)ftab;
  a.itab = (const int32_t*)itab;
  a.q = (int32_t*)q;
  a.dc = (int32_t*)dc;
  a.presets = (const int32_t*)presets;
  a.tokens = (uint16_t*)tokens;
  a.clusters = (uint8_t*)clusters;
  a.residues = (int32_t*)residues;
  a.rbits = (uint8_t*)rbits;
  a.valid_len = (int32_t*)valid_len;
  const int G = gcy * gcx;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0: return launch<uint8_t>(a, G, st);
    case 1: return launch<uint16_t>(a, G, st);
    case 2: return launch<float>(a, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
