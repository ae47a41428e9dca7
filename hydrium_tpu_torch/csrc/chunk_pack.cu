// Chunk pack: variable-width fields -> word-aligned chunks (payload
// format v3), for both chunk streams of one dispatch in one launch.
// Chunk r of a stream packs fields [r*ch, (r+1)*ch) LSB-first from bit 0
// of its own [ow]-word row; bits at or beyond ow*32 are dropped (such a
// chunk overflows, and the payload's ok word then rejects it), words past
// the chunk's bits are zero.  chunk_bits[r] is the chunk's full bit count.
// Fields are (value, width) pairs with width <= 32 and value < 2^width.
//
// Replaces the TPU kernel hydrium_tpu/ops/pallas/bitpack.py::
// merge_pack_chunks (_merge_pack_kernel) together with its XLA pre-passes
// (pipeline._quad_fields, _oct_fields, the bit-reversed to_cols).  Those
// existed because Mosaic could not place fields by computed word index:
// the TPU kernel merged segments pairwise with per-column barrel shifts.
// A CUDA block can scan and scatter directly, so none of that carries
// over.
//
// Bound on the card: device-memory bytes.  Per field 8 bytes are read
// (u32 value, i32 width); per chunk ow*4 bytes of row and 4 of chunk_bits
// are written.  A 2048^2 LF group's pair (3072 token chunks of 4096
// fields, 6144 residue chunks of 2048) moves ~240 MB, 72 us at 3.35 TB/s.
//
// Design, against what held back the one-block-per-chunk kernel before it
// (cub::BlockLoad of values, then of widths, through one TempStorage;
// 48 registers of fields per thread for a token chunk; up to 2 shared
// atomics per field; two launches per dispatch):
// - One launch takes a work list: items [0, R0) are the first stream's
//   chunks, [R0, R0 + R1) the second's (the token and the residue stream
//   of one dispatch; R1 = 0 is a one-stream call).  The grid is
//   persistent: min(items, resident blocks), block b taking items b,
//   b + grid, ...  So a dispatch launches once, and an edge tile's 48 +
//   96 chunks run as one wave on 132 SMs where they were two launches.
// - Loads are bulk async copies (cp.async.bulk, the TMA's 1-D form) into
//   a two-slot ring in shared memory: one thread asks for an item's
//   values and widths together (32 KB for a token chunk) on the slot's
//   mbarrier with expect_tx, two items ahead, while the block packs.  No
//   thread holds registers for a load in flight.
// - Each thread takes 4 consecutive fields per 1024-field stripe as one
//   16-byte shared load of values and one of widths (a warp reads 512
//   contiguous bytes, free of bank conflicts), at most 4 stripes: 32
//   registers of fields.  One warp scan over all stripes at once, then
//   one warp over the stripe-by-warp sums, gives every 4-field quad its
//   bit offset.
// - A quad composes its <= 128 bits in registers (two 64-bit pairs and
//   funnel shifts) and writes the words it alone covers with plain
//   shared stores; only its first and last word, which it may share with
//   a neighbour, take an atomicOr: at most 2 shared atomics per 4 fields.
// - The row is zeroed in shared memory before the pack and written out
//   with 16-byte coalesced stores, which retire while the block goes on
//   to the next item, so one row buffer serves; chunk_bits is written
//   once per item.  (A bulk copy shared -> global from two row buffers,
//   after fence.proxy.async, measured no faster on the H100, and a third
//   slot or 512 threads a block did not move the time either: PERF.md
//   section 6, measured with profile_pack.py --variant.)
// Rows are 6,208 or 3,136 bytes; bulk copies and 16-byte stores need
// aligned addresses, so ow % 4 == 0 and every pointer is 16-byte aligned
// (the wrapper checks and raises).
//
// Plain twin: hydrium_tpu_torch/ops/bitpack.py pack_chunks_plain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStripeFields = 4 * kThreads;       // one quad per thread
constexpr int kMaxStripes = 4;                     // ch <= 4096
constexpr int kMaxCh = kStripeFields * kMaxStripes;
constexpr int kMaxOw = 2048;
constexpr int kSlotBytes = kMaxCh * 8;             // values | widths
constexpr int kSlots = 2;                          // items loaded ahead
constexpr int kSmemBytes = kSlots * kSlotBytes + kMaxOw * 4;
constexpr int kMaxDevices = 64;

struct Stream {
  const uint32_t* values;
  const int32_t* nbits;
  uint32_t* chunks;
  int32_t* chunk_bits;
  long long rows;
  int ch, ow;
};

struct Args {
  Stream s0, s1;
  long long items;
};

// one work item: a chunk of either stream
struct Item {
  const uint32_t* values;
  const int32_t* nbits;
  uint32_t* row_out;
  int32_t* bits_out;
  int ch, ow;
};

__device__ __forceinline__ Item item_at(const Args& a, long long i) {
  const bool hi = i >= a.s0.rows;
  const long long r = hi ? i - a.s0.rows : i;
  Item it;
  it.ch = hi ? a.s1.ch : a.s0.ch;
  it.ow = hi ? a.s1.ow : a.s0.ow;
  it.values = (hi ? a.s1.values : a.s0.values) + r * it.ch;
  it.nbits = (hi ? a.s1.nbits : a.s0.nbits) + r * it.ch;
  it.row_out = (hi ? a.s1.chunks : a.s0.chunks) + r * it.ow;
  it.bits_out = (hi ? a.s1.chunk_bits : a.s0.chunk_bits) + r;
  return it;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one thread: both halves of an item into a slot, completing on bar
__device__ __forceinline__ void load_item(const Item& it, uint8_t* slot, uint64_t* bar) {
  const uint32_t bytes = (uint32_t)it.ch * 4u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(2u * bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(slot)),
      "l"((uint64_t)it.values), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(slot + kSlotBytes / 2)),
      "l"((uint64_t)it.nbits), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// place one quad (4 fields, nq > 0 bits in all) at bit offset off of row
__device__ __forceinline__ void put_quad(uint32_t* row, int ow, int off, int nq, uint4 v,
                                         uint4 b) {
  const uint32_t s = (uint32_t)off & 31u;
  const int w0 = off >> 5;
  // fields 0|1 and 2|3 as two <= 64-bit values; 2|3 starts t bits into
  // word w0, so in word jb <= 2 at bit sb
  const unsigned long long p01 = (unsigned long long)v.x | ((unsigned long long)v.y << b.x);
  const unsigned long long p23 = (unsigned long long)v.z | ((unsigned long long)v.w << b.z);
  const uint32_t t = s + b.x + b.y, jb = t >> 5, sb = t & 31u;
  const uint32_t lo = (uint32_t)p01, hi = (uint32_t)(p01 >> 32);
  const uint32_t lo2 = (uint32_t)p23, hi2 = (uint32_t)(p23 >> 32);
  const uint32_t a0 = lo << s, a1 = __funnelshift_l(lo, hi, s), a2 = __funnelshift_l(hi, 0u, s);
  const uint32_t c0 = lo2 << sb, c1 = __funnelshift_l(lo2, hi2, sb),
                 c2 = __funnelshift_l(hi2, 0u, sb);
  const uint32_t x0 = a0 | (jb == 0 ? c0 : 0u);
  const uint32_t x1 = a1 | (jb == 0 ? c1 : jb == 1 ? c0 : 0u);
  const uint32_t x2 = a2 | (jb == 0 ? c2 : jb == 1 ? c1 : c0);
  const uint32_t x3 = jb == 1 ? c2 : jb == 2 ? c1 : 0u;
  const uint32_t x4 = jb == 2 ? c2 : 0u;
  const int last = (int)((s + (uint32_t)nq - 1u) >> 5);     // 0..4
  // the first and last word may hold a neighbour's bits too; the words
  // between are this quad's alone
  if (w0 < ow && x0 != 0u) atomicOr(&row[w0], x0);
  if (1 < last && w0 + 1 < ow) row[w0 + 1] = x1;
  if (2 < last && w0 + 2 < ow) row[w0 + 2] = x2;
  if (3 < last && w0 + 3 < ow) row[w0 + 3] = x3;
  if (last > 0) {
    const uint32_t xl = last == 1 ? x1 : last == 2 ? x2 : last == 3 ? x3 : x4;
    if (w0 + last < ow && xl != 0u) atomicOr(&row[w0 + last], xl);
  }
}

__global__ void __launch_bounds__(kThreads, 2) chunk_pack_streams_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kSlots];
  __shared__ int warp_sum[kMaxStripes * kWarps];
  uint32_t* row = (uint32_t*)(smem + kSlots * kSlotBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long grid = gridDim.x;

  if (tid == 0) {
    for (int k = 0; k < kSlots; ++k) bar_init(&full[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < kSlots; ++k) {
      const long long i = blockIdx.x + k * grid;
      if (i < a.items) load_item(item_at(a, i), smem + k * kSlotBytes, &full[k]);
    }
  }

  int slot = 0;
  uint32_t parity = 0;    // of the slot's current load, flipping per ring turn
  for (long long i = blockIdx.x; i < a.items; i += grid) {
    const Item cur = item_at(a, i);
    const int stripes = cur.ch / kStripeFields;
    const uint4* vq = (const uint4*)(smem + slot * kSlotBytes);
    const uint4* bq = (const uint4*)(smem + slot * kSlotBytes + kSlotBytes / 2);

    bar_wait(&full[slot], parity);
    uint4 v[kMaxStripes], b[kMaxStripes];
    int n[kMaxStripes], inc[kMaxStripes];
#pragma unroll
    for (int k = 0; k < kMaxStripes; ++k) {
      if (k < stripes) {
        v[k] = vq[k * kThreads + tid];
        b[k] = bq[k * kThreads + tid];
      } else {
        v[k] = b[k] = make_uint4(0u, 0u, 0u, 0u);
      }
      n[k] = inc[k] = (int)(b[k].x + b[k].y + b[k].z + b[k].w);
    }
    // the slot is read, and the previous item's row stored: refill the
    // slot with the item kSlots ahead, and clear the row
    __syncthreads();
    if (tid == 0 && i + kSlots * grid < a.items)
      load_item(item_at(a, i + kSlots * grid), smem + slot * kSlotBytes, &full[slot]);
    for (int w = tid; w < cur.ow / 4; w += kThreads)
      ((uint4*)row)[w] = make_uint4(0u, 0u, 0u, 0u);

    // inclusive scan of the quads' bit counts within each warp, for
    // every stripe at once, then over (stripe, warp) in warp 0
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int k = 0; k < kMaxStripes; ++k) {
        if (k < stripes) {
          const int y = __shfl_up_sync(0xffffffffu, inc[k], d);
          if (lane >= d) inc[k] += y;
        }
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < kMaxStripes; ++k)
        if (k < stripes) warp_sum[k * kWarps + warp] = inc[k];
    }
    __syncthreads();
    if (warp == 0) {
      const int m = stripes * kWarps;
      const int x = lane < m ? warp_sum[lane] : 0;
      int y = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int z = __shfl_up_sync(0xffffffffu, y, d);
        if (lane >= d) y += z;
      }
      if (lane < m) warp_sum[lane] = y - x;
      if (lane == m - 1) *cur.bits_out = y;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kMaxStripes; ++k) {
      if (k < stripes && n[k] > 0)
        put_quad(row, cur.ow, warp_sum[k * kWarps + warp] + inc[k] - n[k], n[k], v[k], b[k]);
    }
    __syncthreads();
    for (int w = tid; w < cur.ow / 4; w += kThreads)
      ((uint4*)cur.row_out)[w] = ((const uint4*)row)[w];
    if (++slot == kSlots) {
      slot = 0;
      parity ^= 1u;
    }
  }
}

// resident blocks of the kernel on each device (0 = not yet asked); the
// same value is written by every racing caller
int g_grid_cap[kMaxDevices];

int grid_cap(int* cap) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < kMaxDevices && g_grid_cap[dev] > 0) {
    *cap = g_grid_cap[dev];
    return 0;
  }
  e = cudaFuncSetAttribute(chunk_pack_streams_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunk_pack_streams_kernel,
                                                    kThreads, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *cap = sms * per_sm;
  if (dev >= 0 && dev < kMaxDevices) g_grid_cap[dev] = *cap;
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

bool valid(const Stream& s) {
  if (s.rows < 0) return false;
  if (s.rows == 0) return true;
  return (s.ch == 1024 || s.ch == 2048 || s.ch == 4096) && s.ow >= 4 && s.ow <= kMaxOw &&
         s.ow % 4 == 0 && aligned16(s.values) && aligned16(s.nbits) && aligned16(s.chunks);
}

}  // namespace

// Two streams, each: values u32 / nbits i32 [rows * ch], chunks u32
// [rows, ow], chunk_bits i32 [rows]; rows = 0 leaves a stream out.
// ch in {1024, 2048, 4096}; ow a multiple of 4 up to 2048; values, nbits
// and chunks 16-byte aligned.
extern "C" int hyd_chunk_pack(const void* values0, const void* nbits0, long long rows0,
                              int ch0, int ow0, void* chunks0, void* chunk_bits0,
                              const void* values1, const void* nbits1, long long rows1,
                              int ch1, int ow1, void* chunks1, void* chunk_bits1,
                              void* stream) {
  Args a;
  a.s0 = {(const uint32_t*)values0, (const int32_t*)nbits0, (uint32_t*)chunks0,
          (int32_t*)chunk_bits0, rows0, ch0, ow0};
  a.s1 = {(const uint32_t*)values1, (const int32_t*)nbits1, (uint32_t*)chunks1,
          (int32_t*)chunk_bits1, rows1, ch1, ow1};
  if (!valid(a.s0) || !valid(a.s1)) return (int)cudaErrorInvalidValue;
  a.items = rows0 + rows1;
  if (a.items == 0) return 0;
  int cap = 0;
  const int rc = grid_cap(&cap);
  if (rc != 0) return rc;
  const long long blocks = a.items < cap ? a.items : cap;
  chunk_pack_streams_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
