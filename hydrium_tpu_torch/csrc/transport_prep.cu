// Transport prep: the whole transport stage of the packed tail in one
// launch.  The front's [N, 64] token/residue tensors -> four flat
// [M = 64 N] streams in slot order (transport Huffman code and length per
// token slot, residue word and width per slot, all zero past each
// block-channel's valid length), the HS-sampled per-class token histogram
// [9 * 64] (counts scaled by HS) and the tok_ok flag (every valid token
// fits the 64-symbol transport alphabet).
//
// Replaces the TPU kernel hydrium_tpu/ops/pallas/prep.py::transport_prep
// (_prep_kernel) and the XLA passes around it in
// hydrium_tpu/ops/pipeline.py::_hf_transport_streams (the valid mask, the
// tok_ok reduction, the sampled histogram).  The Pallas kernel received
// its five inputs pre-packed into two (pack_p16) and rebuilt flat order
// with roll/concat doubling in VMEM, and looked the codes up with one-hot
// matmuls, because XLA:TPU priced gathers and [N,64]->[M] relayouts far
// above their byte cost.  None of that carries over: a row-major [N, 64]
// tensor already IS flat slot order, and a gather from a 9x64 table in
// shared memory costs one shared load.
//
// Bound on the card: device-memory bytes.  Per slot it reads 8 bytes
// (u16 token, u8 cluster, u32 residue, u8 width) and writes 16, plus 4
// bytes of valid_len per 64 slots: a 2048^2 LF group (M = 12.6 M slots)
// moves ~303 MB, 90 us at 3.35 TB/s.  Design:
// - each warp takes 256 consecutive slots (4 block-channel rows) per
//   step, and each thread 8 of them as two runs of 4: lane l owns slots
//   [4l, 4l + 4) and [128 + 4l, 128 + 4l + 4).  Every warp-wide access
//   is then one contiguous run: 8-byte token loads, 4-byte cluster and
//   width loads, 16-byte residue loads and one 16-byte store per stream
//   and run (512 bytes per warp instruction).  valid_len is loaded once
//   per run.  (8 consecutive slots per thread -- one 16-byte token load,
//   two 16-byte stores per stream -- leave each warp instruction writing
//   half of every 32-byte sector it touches; that layout reached 67% of
//   the bound on the H100, this one 77%.)
// - the class x token table (code | len << 16) and a 256-entry
//   cluster -> class * 64 table live in shared memory, built once per
//   block, so no slot computes a modulo;
// - the histogram of the sampled rows (row % HS == 0) goes into a
//   shared int32 [576] with shared atomics; each block adds its nonzero
//   bins, times HS, to the global histogram with integer atomics, so the
//   result is exact and does not depend on the order;
// - a warp vote clears the tok_ok byte when a valid token is >= 64; it
//   stays on the device;
// - the grid is the card's resident blocks (at least two per SM), each
//   looping over warp steps, so each block flushes its histogram once.
// The host function zeroes the histogram and sets tok_ok before the
// launch (two memsets on the same stream).
//
// Plain twin: hydrium_tpu_torch/ops/transport.py transport_prep_plain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 9 * 64;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint4 as_u4(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads) transport_prep_kernel(
    const uint16_t* __restrict__ tokens, const uint8_t* __restrict__ clusters,
    const int32_t* __restrict__ valid_len, const uint32_t* __restrict__ residues,
    const uint8_t* __restrict__ residue_bits, const int32_t* __restrict__ tok_len,
    const int32_t* __restrict__ tok_code, int tok_classes, long long n_rows, int hs,
    uint32_t* __restrict__ t_flat, uint32_t* __restrict__ t_bits,
    uint32_t* __restrict__ r_flat, uint32_t* __restrict__ r_bits,
    int32_t* __restrict__ hist, uint8_t* __restrict__ tok_ok) {
  __shared__ uint32_t tab[kBins];       // code | len << 16, class * 64 + token
  __shared__ uint16_t cls_base[256];    // cluster -> (cluster % tok_classes) * 64
  __shared__ int32_t s_hist[kBins];
  for (int i = threadIdx.x; i < tok_classes * 64; i += kThreads)
    tab[i] = (uint32_t)tok_code[i] | ((uint32_t)tok_len[i] << 16);
  for (int i = threadIdx.x; i < 256; i += kThreads)
    cls_base[i] = (uint16_t)((i % tok_classes) * 64);
  for (int i = threadIdx.x; i < kBins; i += kThreads) s_hist[i] = 0;
  __syncthreads();

  const long long n_slots = n_rows * 64;
  const long long n_warps = (long long)gridDim.x * (kThreads / 32);
  const int lane = threadIdx.x & 31;
  bool bad = false;
  for (long long w = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       w * 256 < n_slots; w += n_warps) {
    // both runs' loads first, then both runs' work and stores
    uint2 tk[2];
    uint32_t cl[2], wb[2];
    uint4 rr[2];
    int vl[2];
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = w * 256 + h * 128 + lane * 4;
      in[h] = m < n_slots;              // n_slots is a multiple of 64
      if (in[h]) {
        vl[h] = __ldg(valid_len + (m >> 6));
        tk[h] = __ldg(reinterpret_cast<const uint2*>(tokens + m));
        cl[h] = __ldg(reinterpret_cast<const uint32_t*>(clusters + m));
        wb[h] = __ldg(reinterpret_cast<const uint32_t*>(residue_bits + m));
        rr[h] = __ldg(reinterpret_cast<const uint4*>(residues + m));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!in[h]) continue;
      const long long m = w * 256 + h * 128 + lane * 4;
      const int s0 = (int)(m & 63);
      const bool sampled = (m >> 6) % hs == 0;
      const uint32_t tw[2] = {tk[h].x, tk[h].y};
      const uint32_t rv[4] = {rr[h].x, rr[h].y, rr[h].z, rr[h].w};
      uint32_t code[4], len[4], res[4], rbits[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t tok = (tw[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu;
        const uint32_t c = (cl[h] >> (k * 8)) & 0xFFu;
        const uint32_t b = (wb[h] >> (k * 8)) & 0xFFu;
        const bool valid = s0 + k < vl[h];
        const uint32_t bin = cls_base[c] + min(tok, 63u);
        const uint32_t e = tab[bin];
        code[k] = valid ? (e & 0xFFFFu) : 0u;
        len[k] = valid ? (e >> 16) : 0u;
        res[k] = valid ? rv[k] : 0u;
        rbits[k] = valid ? b : 0u;
        bad |= valid && tok >= 64;
        if (valid && sampled) atomicAdd(&s_hist[bin], 1);
      }
      *reinterpret_cast<uint4*>(t_flat + m) = as_u4(code);
      *reinterpret_cast<uint4*>(t_bits + m) = as_u4(len);
      *reinterpret_cast<uint4*>(r_flat + m) = as_u4(res);
      *reinterpret_cast<uint4*>(r_bits + m) = as_u4(rbits);
    }
  }
  if (__any_sync(0xFFFFFFFFu, bad) && lane == 0) *tok_ok = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    const int32_t v = s_hist[i];
    if (v) atomicAdd(hist + i, v * hs);
  }
}

// resident blocks of transport_prep_kernel on each device (0 = not yet
// asked); the same value is written by every racing caller
int g_grid_cap[kMaxDevices];

int grid_cap(int* cap) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < kMaxDevices && g_grid_cap[dev] > 0) {
    *cap = g_grid_cap[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, transport_prep_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *cap = sms * (per_sm < 2 ? 2 : per_sm);
  if (dev >= 0 && dev < kMaxDevices) g_grid_cap[dev] = *cap;
  return 0;
}

}  // namespace

// All [N, 64] arrays and the four outputs must be 16-byte aligned
// (the wrapper checks).  hist: int32 [576]; tok_ok: one byte.
extern "C" int hyd_transport_prep(const void* tokens, const void* clusters,
                                  const void* valid_len, const void* residues,
                                  const void* residue_bits, const void* tok_len,
                                  const void* tok_code, int tok_classes,
                                  long long n_rows, int hs, void* t_flat,
                                  void* t_bits, void* r_flat, void* r_bits,
                                  void* hist, void* tok_ok, void* stream) {
  if (tok_classes < 1 || tok_classes > 9 || n_rows < 0 || hs < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(hist, 0, kBins * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(tok_ok, 1, 1, s);
  if (e != cudaSuccess) return (int)e;
  if (n_rows == 0) return 0;
  int cap = 0;
  const int rc = grid_cap(&cap);
  if (rc != 0) return rc;
  const long long warps = (n_rows + 3) / 4;    // one warp per 256 slots
  long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > cap) blocks = cap;
  transport_prep_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const uint16_t*)tokens, (const uint8_t*)clusters, (const int32_t*)valid_len,
      (const uint32_t*)residues, (const uint8_t*)residue_bits, (const int32_t*)tok_len,
      (const int32_t*)tok_code, tok_classes, n_rows, hs, (uint32_t*)t_flat,
      (uint32_t*)t_bits, (uint32_t*)r_flat, (uint32_t*)r_bits, (int32_t*)hist,
      (uint8_t*)tok_ok);
  return (int)cudaGetLastError();
}
