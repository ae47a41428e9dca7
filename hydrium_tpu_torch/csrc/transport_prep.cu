// Transport prep: the front's [N, 64] token/residue tensors -> four flat
// [M = 64 N] streams in slot order (transport Huffman code and length per
// token slot, residue word and width per slot), zeroed past each
// block-channel's valid length.
//
// Replaces the TPU kernel hydrium_tpu/ops/pallas/prep.py::transport_prep
// (_prep_kernel).  That kernel received its five inputs pre-packed into
// two (pack_p16) and rebuilt flat order with roll/concat doubling in
// VMEM, and looked the codes up with one-hot matmuls, because XLA:TPU
// priced gathers and [N,64]->[M] relayouts far above their byte cost.
// None of that carries over: a row-major [N, 64] tensor already IS flat
// slot order, and a gather from a 9x64 table in shared memory costs one
// shared load.
//
// Bound on the card: device-memory bytes.  Per slot it reads 8 bytes
// (u16 token, u8 cluster, u32 residue, u8 width; valid_len once per 64
// slots) and writes 16, so a 2048^2 LF group (M = 12.6 M slots) moves
// ~300 MB.  Design: one thread per slot, consecutive threads on
// consecutive slots (coalesced loads and stores), the class x token table
// staged once per block in shared memory as code | len << 16.  Simple
// first; vectorised 16-byte accesses are later work.
//
// Plain twin: hydrium_tpu_torch/ops/transport.py transport_prep_plain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void transport_prep_kernel(
    const uint16_t* __restrict__ tokens, const uint8_t* __restrict__ clusters,
    const int32_t* __restrict__ valid_len, const uint32_t* __restrict__ residues,
    const uint8_t* __restrict__ residue_bits, const int32_t* __restrict__ tok_len,
    const int32_t* __restrict__ tok_code, int tok_classes, long long m_total,
    uint32_t* __restrict__ t_flat, int32_t* __restrict__ t_bits,
    uint32_t* __restrict__ r_flat, int32_t* __restrict__ r_bits) {
  __shared__ uint32_t tab[9 * 64];
  for (int i = threadIdx.x; i < tok_classes * 64; i += blockDim.x)
    tab[i] = (uint32_t)tok_code[i] | ((uint32_t)tok_len[i] << 16);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       m < m_total; m += stride) {
    const int slot = (int)(m & 63);
    uint32_t code = 0, len = 0, res = 0;
    int32_t rb = 0;
    if (slot < valid_len[m >> 6]) {
      const int t = min((int)tokens[m], 63);
      const int cls = (int)clusters[m] % tok_classes;
      const uint32_t e = tab[cls * 64 + t];
      code = e & 0xFFFFu;
      len = e >> 16;
      res = residues[m];
      rb = residue_bits[m];
    }
    t_flat[m] = code;
    t_bits[m] = (int32_t)len;
    r_flat[m] = res;
    r_bits[m] = rb;
  }
}

}  // namespace

extern "C" int hyd_transport_prep(const void* tokens, const void* clusters,
                                  const void* valid_len, const void* residues,
                                  const void* residue_bits, const void* tok_len,
                                  const void* tok_code, int tok_classes,
                                  long long n_rows, void* t_flat, void* t_bits,
                                  void* r_flat, void* r_bits, void* stream) {
  if (tok_classes < 1 || tok_classes > 9 || n_rows < 0) return (int)cudaErrorInvalidValue;
  const long long m_total = n_rows * 64;
  if (m_total == 0) return 0;
  const int threads = 256;
  long long blocks = (m_total + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  transport_prep_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)tokens, (const uint8_t*)clusters, (const int32_t*)valid_len,
      (const uint32_t*)residues, (const uint8_t*)residue_bits, (const int32_t*)tok_len,
      (const int32_t*)tok_code, tok_classes, m_total, (uint32_t*)t_flat,
      (int32_t*)t_bits, (uint32_t*)r_flat, (int32_t*)r_bits);
  return (int)cudaGetLastError();
}
