// Chunk pack: variable-width fields -> word-aligned chunks (payload
// format v3).  Chunk r packs fields [r*ch, (r+1)*ch) LSB-first from bit 0
// of its own [ow]-word row; bits at or beyond ow*32 are dropped (such a
// chunk overflows, and the payload's ok word then rejects it), words past
// the chunk's bits are zero.  chunk_bits[r] is the chunk's full bit count.
//
// Replaces the TPU kernel hydrium_tpu/ops/pallas/bitpack.py::
// merge_pack_chunks (_merge_pack_kernel) together with its XLA pre-passes
// (pipeline._quad_fields, _oct_fields, the bit-reversed to_cols).  Those
// existed because Mosaic could not place fields by computed word index:
// the TPU kernel merged segments pairwise with per-column barrel shifts,
// entering at the oct level to keep VMEM tiles full.  A CUDA block can
// scan and scatter directly, so none of the pre-passes carry over.
//
// Bound on the card: device-memory bytes (8 bytes read per field, up to
// ow*4 bytes written per chunk), plus shared-memory atomics where fields
// share a word.  Design: one block per chunk, 256 threads, ch/256
// consecutive fields per thread.  cub::BlockLoad (transposing through
// shared memory, so the global loads stay coalesced) brings each
// thread's fields in; cub::BlockScan gives every field its exclusive
// bit offset; each field ORs into at most two words of a shared-memory
// row, which is then stored whole.
//
// Plain twin: hydrium_tpu_torch/ops/bitpack.py pack_chunks_plain.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_load.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;

template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
chunk_pack_kernel(const uint32_t* __restrict__ values,
                  const int32_t* __restrict__ nbits, int ow,
                  uint32_t* __restrict__ chunks, int32_t* __restrict__ chunk_bits) {
  using LoadV = cub::BlockLoad<uint32_t, kThreads, ITEMS, cub::BLOCK_LOAD_TRANSPOSE>;
  using LoadB = cub::BlockLoad<int32_t, kThreads, ITEMS, cub::BLOCK_LOAD_TRANSPOSE>;
  using Scan = cub::BlockScan<int32_t, kThreads>;
  __shared__ union {
    typename LoadV::TempStorage load_v;
    typename LoadB::TempStorage load_b;
    typename Scan::TempStorage scan;
  } tmp;
  extern __shared__ uint32_t words[];

  const long long r = blockIdx.x;
  const long long base = r * (long long)(kThreads * ITEMS);
  uint32_t v[ITEMS];
  int32_t b[ITEMS], off[ITEMS];
  LoadV(tmp.load_v).Load(values + base, v);
  __syncthreads();
  LoadB(tmp.load_b).Load(nbits + base, b);
  __syncthreads();
  int32_t total;
  Scan(tmp.scan).ExclusiveSum(b, off, total);
  for (int i = threadIdx.x; i < ow; i += kThreads) words[i] = 0u;
  __syncthreads();

#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const uint32_t u = v[k];
    if (u == 0u) continue;
    const int w = off[k] >> 5;
    const int s = off[k] & 31;
    if (w < ow) atomicOr(&words[w], u << s);
    if (s != 0 && w + 1 < ow) {
      const uint32_t hi = u >> (32 - s);
      if (hi != 0u) atomicOr(&words[w + 1], hi);
    }
  }
  __syncthreads();

  uint32_t* out = chunks + r * (long long)ow;
  for (int i = threadIdx.x; i < ow; i += kThreads) out[i] = words[i];
  if (threadIdx.x == 0) chunk_bits[r] = total;
}

template <int ITEMS>
void launch(const void* values, const void* nbits, long long n_chunks, int ow,
            void* chunks, void* chunk_bits, cudaStream_t stream) {
  chunk_pack_kernel<ITEMS><<<(unsigned)n_chunks, kThreads, ow * sizeof(uint32_t), stream>>>(
      (const uint32_t*)values, (const int32_t*)nbits, ow, (uint32_t*)chunks,
      (int32_t*)chunk_bits);
}

}  // namespace

// ch must be 256 * {1, 2, 4, 8, 16}; ow * 4 bytes must fit the default
// 48 KB of dynamic shared memory next to the scan's storage.
extern "C" int hyd_chunk_pack(const void* values, const void* nbits,
                              long long n_chunks, int ch, int ow, void* chunks,
                              void* chunk_bits, void* stream) {
  if (n_chunks < 0 || n_chunks > 0x7FFFFFFFLL || ow < 1 || ow > 8192)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case kThreads * 1: launch<1>(values, nbits, n_chunks, ow, chunks, chunk_bits, s); break;
    case kThreads * 2: launch<2>(values, nbits, n_chunks, ow, chunks, chunk_bits, s); break;
    case kThreads * 4: launch<4>(values, nbits, n_chunks, ow, chunks, chunk_bits, s); break;
    case kThreads * 8: launch<8>(values, nbits, n_chunks, ow, chunks, chunk_bits, s); break;
    case kThreads * 16: launch<16>(values, nbits, n_chunks, ow, chunks, chunk_bits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
