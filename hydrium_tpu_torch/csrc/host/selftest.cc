// Standalone self-test of the port's native serialization plane
// (serializer.cc beside it), built with it under ASAN/UBSAN and
// -DHYD_SELFTEST (which builds in serializer.cc's thread counter) by
// tests/test_torch_native_sanitized.py.  Exercises every hot path with
// randomized streams: LZ77 tokenization, prefix encode (simple + complex
// codes, nested cluster maps), the packed-stream context walker (a
// multi-group grid at 1 and 3 threads, and the counts it refuses), ANS
// table build and backwards emission (single- and multi-threaded, and
// the threads a call starts for its groups), the
// ANS encoder's reverse map against the alias-slot scan it replaced, the
// LF residual decoder, the PNG row defilter against the PNG
// specification's filter definitions, and the transport code's table
// build (complete codes of lengths 1..12 whose LUTs decode them).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {
struct HydWriter;
struct HydStream;
struct HydHF;
HydWriter* hyd_writer_new();
void hyd_writer_free(HydWriter*);
long hyd_writer_bit_size(HydWriter*);
void hyd_writer_write(HydWriter*, uint64_t, int);
long hyd_writer_copy(HydWriter*, uint8_t*, long, uint32_t*, int*);
HydStream* hyd_stream_new(const uint8_t*, long, uint32_t, int, int, int, int,
                          int);
void hyd_stream_free(HydStream*);
void hyd_stream_send_mono(HydStream*, uint32_t, const uint32_t*, long);
int hyd_stream_prefix_finalize(HydStream*, HydWriter*);
HydHF* hyd_hf_new(long);
void hyd_hf_free(HydHF*);
void hyd_hf_add_group(HydHF*, const uint16_t*, const uint8_t*,
                      const uint32_t*, const uint8_t*, const int32_t*, long,
                      uint32_t);
int hyd_hf_add_lfg_packed(HydHF*, const uint32_t*, const uint32_t*,
                          const uint16_t*, int, const uint8_t*, uint32_t,
                          long, long, long, long, const int64_t*,
                          const int64_t*, const int64_t*, int);
int hyd_hf_prepare(HydHF*);
int hyd_hf_encode_all(HydHF*, int, HydWriter**, int);
int hyd_hf_write_header(HydHF*, const uint8_t*, long, HydWriter*);
void hyd_hf_force_las(HydHF*, int);
long hyd_hf_num_groups(HydHF*);
long hyd_threads_started();
int hyd_hf_las(HydHF*);
long hyd_hf_frequencies(HydHF*, long, uint32_t*, long);
int hyd_ans_reverse_map(const uint32_t*, long, int, uint16_t*);
uint64_t hyd_ans_recip(uint32_t);
uint32_t hyd_ans_div(uint32_t, uint32_t);
long hyd_lf_decode(const uint32_t*, const uint16_t*, long, long, uint32_t*);
int hyd_png_unfilter(uint8_t*, const uint8_t*, long, int, int);
int hyd_tok_build_tables(const int64_t*, int32_t*, uint32_t*, uint16_t*);
}

static uint64_t rng_state = 0x9E3779B97F4A7C15ull;
static uint32_t rnd() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return (uint32_t)(rng_state >> 32);
}

static void test_prefix_streams() {
  for (int iter = 0; iter < 20; iter++) {
    uint8_t cm[1] = {0};
    HydStream* s = hyd_stream_new(cm, 1, (iter & 1) ? (1u << 14) : 0,
                                  iter & 1, 1, 7, 1, 1);
    std::vector<uint32_t> syms(1 + rnd() % 5000);
    for (auto& v : syms) {
      v = rnd() % ((iter % 3 == 0) ? 4u : 100000u);
      if (rnd() % 3 == 0 && &v != syms.data()) v = (&v)[-1];  // runs
    }
    hyd_stream_send_mono(s, 0, syms.data(), syms.size());
    HydWriter* w = hyd_writer_new();
    if (hyd_stream_prefix_finalize(s, w) != 0) {
      fprintf(stderr, "prefix finalize failed\n");
      exit(1);
    }
    hyd_writer_free(w);
    hyd_stream_free(s);
  }
  printf("prefix streams ok\n");
}

// build cluster map like tables.hf_cluster_map(1)
static std::vector<uint8_t> hf_map() {
  std::vector<uint8_t> cm(1485);
  for (int j = 0; j < 1485; j++)
    cm[j] = j < 111 ? j % 3 : 3 + (j - 111) % 6;
  return cm;
}

static void test_hf_padded() {
  auto cm = hf_map();
  const int blocks = 1024;
  std::vector<uint16_t> tokens(blocks * 3 * 64);
  std::vector<uint8_t> clusters(blocks * 3 * 64);
  std::vector<uint32_t> residues(blocks * 3 * 64);
  std::vector<uint8_t> rbits(blocks * 3 * 64);
  std::vector<int32_t> valid(blocks * 3);
  for (int b = 0; b < blocks * 3; b++) {
    valid[b] = rnd() % 65;
    for (int k = 0; k < 64; k++) {
      int i = b * 64 + k;
      tokens[i] = rnd() % 40;
      clusters[i] = cm[rnd() % 1485];
      rbits[i] = tokens[i] >= 16 ? ((tokens[i] - 16) >> 1) + 3 : 0;
      residues[i] = rbits[i] ? (rnd() & ((1u << rbits[i]) - 1)) : 0;
    }
  }
  HydHF* h = hyd_hf_new(9);
  for (int g = 0; g < 8; g++)
    hyd_hf_add_group(h, tokens.data(), clusters.data(), residues.data(),
                     rbits.data(), valid.data(), blocks, 0);
  if (hyd_hf_prepare(h) != 0) {
    fprintf(stderr, "prepare failed\n");
    exit(1);
  }
  std::vector<HydWriter*> ws(8);
  for (auto& w : ws) w = hyd_writer_new();
  if (hyd_hf_encode_all(h, 0, ws.data(), 4) != 0) {
    fprintf(stderr, "encode_all failed\n");
    exit(1);
  }
  HydWriter* hw = hyd_writer_new();
  if (hyd_hf_write_header(h, cm.data(), cm.size(), hw) != 0) {
    fprintf(stderr, "header failed\n");
    exit(1);
  }
  hyd_writer_free(hw);
  for (auto* w : ws) hyd_writer_free(w);
  hyd_hf_free(h);
  printf("hf padded ok\n");
}

// Format-v3 packed streams under a fixed-length transport code (all
// symbols 6 bits, canonical LSB-first = reversed 6-bit symbol) + residue
// bits; no valid-length sidecar -- the walker reconstructs symbol counts
// from the decoded nonzero counts.  The streams are word-aligned
// chunked: tokens realign every 64 block-channels, residues every 32,
// counting every block position of the 32x32 buffer group
// (ops/packed.py); each group starts on a word.
struct PackedStreams {
  std::vector<uint32_t> tw, rw;
  uint64_t tcache = 0, rcache = 0;
  int tbits = 0, rbits = 0;

  static uint32_t rev6(uint32_t v) {
    uint32_t r = 0;
    for (int i = 0; i < 6; i++) r |= ((v >> i) & 1) << (5 - i);
    return r;
  }
  static void put(std::vector<uint32_t>& out, uint64_t& cache, int& nbits,
                  uint32_t v, int n) {
    cache |= (uint64_t)v << nbits;
    nbits += n;
    while (nbits >= 32) {
      out.push_back((uint32_t)cache);
      cache >>= 32;
      nbits -= 32;
    }
  }
  void align_tok() { if (tbits) put(tw, tcache, tbits, 0, 32 - tbits); }
  void align_res() { if (rbits) put(rw, rcache, rbits, 0, 32 - rbits); }
  // a hybrid-uint value: its token under the 6-bit code, then its
  // residue bits (tokens >= 16 carry ((tok - 16) >> 1) + 3 of them)
  void value(uint32_t v) {
    if (v < 16) {
      put(tw, tcache, tbits, rev6(v), 6);
      return;
    }
    int rb = (31 - __builtin_clz(v)) - 1;
    uint32_t tok = 16 + (((uint32_t)(rb - 3) << 1) | ((v >> rb) & 1));
    put(tw, tcache, tbits, rev6(tok), 6);
    put(rw, rcache, rbits, v & ((1u << rb) - 1), rb);
  }
  // one buffer group of true extent gbh x gbw blocks, its nonzero
  // coefficients in [2, 2 + span); returns its symbol count and sets
  // its streams' bit offsets
  int64_t group(int gbh, int gbw, uint32_t span, int64_t* toff,
                int64_t* roff) {
    align_tok();
    align_res();
    *toff = (int64_t)tw.size() * 32;
    *roff = (int64_t)rw.size() * 32;
    int64_t syms = 0;
    long tch = 0, rch = 0;
    for (int by = 0; by < gbh; by++)
      for (int bx = 0; bx < gbw; bx++)
        for (int c = 0; c < 3; c++) {
          long bc = ((long)by * 32 + bx) * 3 + c;
          if ((bc >> 6) != tch) align_tok(), tch = bc >> 6;
          if ((bc >> 5) != rch) align_res(), rch = bc >> 5;
          // the nonzero count, then as many nonzero coefficients
          uint32_t nz = rnd() % 4 ? rnd() % 15 : rnd() % 64;
          value(nz);
          for (uint32_t k = 0; k < nz; k++) value(2 + rnd() % span);
          syms += 1 + nz;
        }
    return syms;
  }
  void finish() {  // the walker may peek one word past the end
    put(tw, tcache, tbits, 0, 31);
    put(rw, rcache, rbits, 0, 31);
    tw.push_back(0); rw.push_back(0);
    tw.push_back(0); rw.push_back(0);
  }
};

static std::vector<uint8_t> section_bytes(HydWriter* w) {
  std::vector<uint8_t> out(hyd_writer_bit_size(w) / 8 + 8);
  uint32_t tail = 0;
  int bits = 0;
  long n = hyd_writer_copy(w, out.data(), (long)out.size(), &tail, &bits);
  out.resize(n);
  for (int k = 0; k < 4; k++) out.push_back((uint8_t)(tail >> (8 * k)));
  out.push_back((uint8_t)bits);
  return out;
}

// las, every cluster's frequencies and every section's bytes of a
// HydHF, prepared here, for comparing two walks of the same streams
static std::vector<uint8_t> hf_result(HydHF* h, long n_clusters,
                                      long n_sections) {
  if (hyd_hf_prepare(h) != 0) {
    fprintf(stderr, "packed prepare failed\n");
    exit(1);
  }
  std::vector<uint8_t> out{(uint8_t)hyd_hf_las(h)};
  for (long c = 0; c < n_clusters; c++) {
    uint32_t f[512];
    long a = hyd_hf_frequencies(h, c, f, 512);
    out.insert(out.end(), (uint8_t*)f, (uint8_t*)(f + a));
    out.push_back((uint8_t)a);
  }
  std::vector<HydWriter*> ws(n_sections);
  for (auto& w : ws) w = hyd_writer_new();
  if (hyd_hf_num_groups(h) != n_sections ||
      hyd_hf_encode_all(h, 0, ws.data(), 2) != 0) {
    fprintf(stderr, "packed encode failed\n");
    exit(1);
  }
  for (auto* w : ws) {
    auto b = section_bytes(w);
    out.insert(out.end(), b.begin(), b.end());
    hyd_writer_free(w);
  }
  return out;
}

// hyd_hf_encode_all starts min(n_threads, groups) - 1 threads: none for
// a one-group frame (a 256x256 tile) whatever n_threads, and the
// sections are the same at every thread count.
static void test_encode_all_threads() {
  auto cm = hf_map();
  const int blocks = 256;
  std::vector<uint16_t> tokens(blocks * 3 * 64);
  std::vector<uint8_t> clusters(blocks * 3 * 64);
  std::vector<uint32_t> residues(blocks * 3 * 64, 0);
  std::vector<uint8_t> rbits(blocks * 3 * 64, 0);
  std::vector<int32_t> valid(blocks * 3);
  for (int b = 0; b < blocks * 3; b++) {
    valid[b] = rnd() % 65;
    for (int k = 0; k < 64; k++) {
      tokens[b * 64 + k] = rnd() % 16;
      clusters[b * 64 + k] = cm[rnd() % 1485];
    }
  }
  for (long groups : {1l, 3l, 6l}) {
    std::vector<uint8_t> want;
    for (int n_threads : {1, 4, 16}) {
      HydHF* h = hyd_hf_new(9);
      for (long g = 0; g < groups; g++)
        hyd_hf_add_group(h, tokens.data(), clusters.data(), residues.data(),
                         rbits.data(), valid.data(), blocks, 0);
      if (hyd_hf_prepare(h) != 0) {
        fprintf(stderr, "encode_all threads: prepare failed\n");
        exit(1);
      }
      std::vector<HydWriter*> ws(groups);
      for (auto& w : ws) w = hyd_writer_new();
      long before = hyd_threads_started();
      if (hyd_hf_encode_all(h, 0, ws.data(), n_threads) != 0) {
        fprintf(stderr, "encode_all threads: encode failed\n");
        exit(1);
      }
      long started = hyd_threads_started() - before;
      long expect = std::min((long)n_threads, groups) - 1;
      if (started != expect) {
        fprintf(stderr, "encode_all: %ld groups at %d threads started %ld "
                "threads, not %ld\n", groups, n_threads, started, expect);
        exit(1);
      }
      std::vector<uint8_t> got;
      for (auto* w : ws) {
        auto b = section_bytes(w);
        got.insert(got.end(), b.begin(), b.end());
        hyd_writer_free(w);
      }
      if (n_threads == 1)
        want = got;
      else if (got != want) {
        fprintf(stderr, "encode_all: %ld groups at %d threads differ from "
                "1\n", groups, n_threads);
        exit(1);
      }
      hyd_hf_free(h);
    }
  }
  printf("encode_all threads ok\n");
}

// The packed walker over a 2x3 buffer grid: 2x2 groups with a nonzero
// extent (cut to 16 block columns on the right, 8 block rows at the
// bottom) and a phantom column (a phantom group comes with its whole
// row or column).  Walked at 1 and 3 threads, the results must be the
// same; at 3 threads the largest tokens are in the group of the third
// thread, so its alphabet sizes have to be merged.  A wrong symbol
// count, or a phantom group with symbols, must fail the call and leave
// the HydHF as it was.
static void test_hf_packed() {
  auto cm = hf_map();
  std::vector<uint16_t> lut(9 * 4096);  // 9 classes, one 6-bit code
  for (int k = 0; k < 9; k++)
    for (uint32_t idx = 0; idx < 4096; idx++)
      lut[k * 4096 + idx] =
          (uint16_t)(PackedStreams::rev6(idx & 63) | (6 << 8));
  const long gcy = 2, gcx = 3, vh = 40, vw = 48;
  PackedStreams ps;
  int64_t toff[6] = {}, roff[6] = {}, scount[6] = {};
  const uint32_t span[6] = {8, 16, 0, 256, 32, 0};
  for (long g = 0; g < gcy * gcx; g++) {
    long gbh = std::min(32l, vh - g / gcx * 32);
    long gbw = std::min(32l, vw - g % gcx * 32);
    if (gbh > 0 && gbw > 0)
      scount[g] =
          ps.group((int)gbh, (int)gbw, span[g], &toff[g], &roff[g]);
  }
  ps.finish();
  auto walk = [&](HydHF* h, const int64_t* counts, int threads) {
    return hyd_hf_add_lfg_packed(h, ps.tw.data(), ps.rw.data(), lut.data(),
                                 9, cm.data(), 0, gcy, gcx, vh, vw, toff,
                                 roff, counts, threads);
  };
  auto fresh = [] {
    HydHF* h = hyd_hf_new(9);
    hyd_hf_force_las(h, 8);
    return h;
  };
  HydHF* h1 = fresh();
  HydHF* h3 = fresh();
  if (walk(h1, scount, 1) != 0 || walk(h3, scount, 3) != 0) {
    fprintf(stderr, "packed walk failed\n");
    exit(1);
  }
  auto want = hf_result(h1, 9, 4);
  if (hf_result(h3, 9, 4) != want) {
    fprintf(stderr, "packed walk: 3 threads differ from 1\n");
    exit(1);
  }
  for (int b = 0; b < 2; b++) {
    int64_t bad[6];
    memcpy(bad, scount, sizeof bad);
    if (b == 0)
      bad[4] += 1;  // a real group: its walk ends short of the count
    else
      bad[5] = 3;   // a phantom group
    HydHF* h = fresh();
    if (walk(h, bad, 3) != -1) {
      fprintf(stderr, "packed walk: bad counts (%d) not refused\n", b);
      exit(1);
    }
    if (walk(h, scount, 3) != 0 || hf_result(h, 9, 4) != want) {
      fprintf(stderr, "packed walk after a refusal (%d) differs\n", b);
      exit(1);
    }
    hyd_hf_free(h);
  }
  hyd_hf_free(h1);
  hyd_hf_free(h3);
  printf("hf packed ok\n");
}

// The reference for hyd_ans_reverse_map: the alias table of a normalized
// histogram (entropy.c 184-265) with, per symbol, a list of the slots
// that may hold it (its own bucket first, then each bucket aliased to
// it), and the encoder's linear scan of those slots for the bucket and
// position of (sym, offset): the state's low 12 bits.
struct ScanSlot {
  int32_t cutoff, offset, original;
};

static std::vector<std::vector<ScanSlot>> scan_slots(
    const std::vector<uint32_t>& f, int las) {
  const uint32_t A = (uint32_t)f.size();
  const int uniq_pos = f[A - 1] == 4096 ? (int)A - 1 : -1;
  const uint32_t bucket_size = 1u << (12 - las), table_size = 1u << las;
  std::vector<uint32_t> symbols(table_size, 0), cutoffs(table_size, 0),
      offsets(table_size, 0);
  if (uniq_pos >= 0) {
    for (uint32_t i = 0; i < table_size; i++) {
      symbols[i] = uniq_pos;
      offsets[i] = i * bucket_size;
    }
  } else {
    std::vector<uint8_t> underfull, overfull;
    for (uint32_t pos = 0; pos < A; pos++) {
      cutoffs[pos] = f[pos];
      if (cutoffs[pos] < bucket_size)
        underfull.push_back(pos);
      else if (cutoffs[pos] > bucket_size)
        overfull.push_back(pos);
    }
    for (uint32_t i = A; i < table_size; i++) underfull.push_back(i);
    while (!overfull.empty()) {
      uint8_t u = underfull.back();
      underfull.pop_back();
      uint8_t o = overfull.back();
      overfull.pop_back();
      cutoffs[o] -= bucket_size - cutoffs[u];
      offsets[u] = cutoffs[o];
      symbols[u] = o;
      if (cutoffs[o] < bucket_size)
        underfull.push_back(o);
      else if (cutoffs[o] > bucket_size)
        overfull.push_back(o);
    }
    for (uint32_t sym = 0; sym < table_size; sym++) {
      if (cutoffs[sym] == bucket_size) {
        symbols[sym] = sym;
        cutoffs[sym] = 0;
        offsets[sym] = 0;
      } else {
        offsets[sym] -= cutoffs[sym];
      }
    }
  }
  std::vector<std::vector<ScanSlot>> slots(A);
  for (uint32_t sym = 0; sym < A; sym++)
    slots[sym].push_back({(int32_t)cutoffs[sym], 0, (int32_t)sym});
  for (uint32_t i = 0; i < table_size; i++)
    slots[symbols[i]].push_back(
        {(int32_t)cutoffs[i], (int32_t)offsets[i], (int32_t)i});
  return slots;
}

static int scan_low_bits(const std::vector<ScanSlot>& slots, uint32_t offset,
                         int las) {
  const int log_bucket = 12 - las;
  const uint32_t pos_mask = (1u << log_bucket) - 1;
  for (size_t j = 0; j < slots.size(); j++) {
    uint32_t pos = offset - slots[j].offset;
    int32_t k = (int32_t)pos - slots[j].cutoff;
    if (!(pos & ~pos_mask) && (j > 0 ? k >= 0 : k < 0))
      return (int)(((uint32_t)slots[j].original << log_bucket) | pos);
  }
  return -1;
}

// Random positive weights over A symbols (a zero now and then, never on
// the last) scaled to sum to 4096, each nonzero weight at least 1.
static std::vector<uint32_t> random_hist(uint32_t A) {
  std::vector<uint32_t> w(A);
  uint64_t total = 0;
  for (uint32_t k = 0; k < A; k++) {
    w[k] = (k + 1 < A && rnd() % 5 == 0) ? 0 : 1 + rnd() % 1000;
    total += w[k];
  }
  std::vector<uint32_t> f(A);
  uint32_t sum = 0;
  for (uint32_t k = 0; k < A; k++) {
    f[k] = w[k] ? std::max<uint32_t>(1, (uint32_t)(w[k] * 4096 / total)) : 0;
    sum += f[k];
  }
  while (sum != 4096) {  // the largest weight takes the difference
    uint32_t m = (uint32_t)(std::max_element(f.begin(), f.end()) - f.begin());
    if (sum < 4096) {
      f[m] += 4096 - sum;
      sum = 4096;
    } else {
      uint32_t by = std::min(sum - 4096, f[m] - 1);
      f[m] -= by;
      sum -= by;
    }
  }
  return f;
}

// Every (symbol, offset < f[symbol]) of each histogram at las 5 to 8:
// the reverse map's low bits must be what the slot scan finds.
static void test_ans_reverse_map() {
  long checked = 0;
  for (int las = 5; las <= 8; las++) {
    const uint32_t T = 1u << las, bucket = 4096 / T;
    std::vector<std::vector<uint32_t>> hists;
    for (uint32_t A : {1u, 2u, 3u, 17u, T}) {  // uniform
      std::vector<uint32_t> f(A, 4096 / A);
      f[0] += 4096 % A;
      hists.push_back(f);
    }
    for (uint32_t A : {1u, 2u, 17u, T}) {  // all mass on the last symbol
      std::vector<uint32_t> f(A, 0);
      f[A - 1] = 4096;
      hists.push_back(f);
    }
    for (uint32_t A : {2u, 17u, T}) {  // all mass on another symbol
      std::vector<uint32_t> f(A, 0);
      f[rnd() % (A - 1)] = 4096;
      hists.push_back(f);
    }
    for (uint32_t a : {1u, 2u, bucket, 2048u, 4095u, 1 + rnd() % 4095}) {
      for (uint32_t A : {2u, 17u, T}) {  // two symbols summing to 4096
        std::vector<uint32_t> f(A, 0);
        uint32_t i = rnd() % A, j = (i + 1 + rnd() % (A - 1)) % A;
        f[i] = a;
        f[j] = 4096 - a;
        hists.push_back(f);
      }
    }
    for (uint32_t top : {4000u, 4050u, 4096u - (T - 1)}) {  // one dominant
      std::vector<uint32_t> f(T, 0);
      f[rnd() % T] = top;
      for (uint32_t left = 4096 - top; left; left--) {
        uint32_t k;
        do k = rnd() % T; while (f[k] >= top);
        f[k]++;
      }
      hists.push_back(f);
    }
    for (uint32_t A : {3u, 17u, T}) {  // many at exactly the bucket size
      std::vector<uint32_t> f(A, 0);
      uint32_t full = std::min(A - 1, T / 2), left = 4096 - full * bucket;
      for (uint32_t k = 0; k < full; k++) f[(k * 7) % A] = bucket;
      for (uint32_t k = 0; k < A && left; k++) {
        if (f[k]) continue;
        uint32_t take = k + 1 == A ? left : std::min(left, rnd() % (2 * bucket + 1));
        f[k] = take;
        left -= take;
      }
      if (left) {  // every symbol already took its share
        uint32_t k = 0;
        while (f[k] != bucket) k++;
        f[k] += left;
      }
      hists.push_back(f);
    }
    for (int seed = 0; seed < 8; seed++)
      for (uint32_t A : {1u, 2u, 17u, T}) hists.push_back(random_hist(A));

    for (const auto& f : hists) {
      uint32_t sum = 0;
      for (uint32_t v : f) sum += v;
      if (sum != 4096) {
        fprintf(stderr, "ans reverse map: test histogram sums to %u\n", sum);
        exit(1);
      }
      std::vector<uint16_t> rev(4096, 0xFFFF);
      if (hyd_ans_reverse_map(f.data(), (long)f.size(), las, rev.data()) !=
          0) {
        fprintf(stderr, "ans reverse map refused a histogram (las %d)\n",
                las);
        exit(1);
      }
      auto slots = scan_slots(f, las);
      uint32_t base = 0;
      for (uint32_t s = 0; s < f.size(); s++) {
        for (uint32_t o = 0; o < f[s]; o++, checked++) {
          int want = scan_low_bits(slots[s], o, las);
          if (want < 0 || rev[base + o] != want) {
            fprintf(stderr,
                    "ans reverse map: las %d, A %zu, symbol %u, offset %u: "
                    "%d, the scan %d\n",
                    las, f.size(), s, o, (int)rev[base + o], want);
            exit(1);
          }
        }
        base += f[s];
      }
    }
  }
  std::vector<uint32_t> bad = {4000, 95};  // sums to 4095
  std::vector<uint16_t> rev(4096);
  if (hyd_ans_reverse_map(bad.data(), 2, 8, rev.data()) != -1) {
    fprintf(stderr, "ans reverse map: a sum of 4095 not refused\n");
    exit(1);
  }
  printf("ans reverse map ok (%ld offsets)\n", checked);
}

// The encoder's division by a reciprocal: for every freq in 1..4096 the
// bound that makes it exact for all states below 2^32 (recip * freq
// exceeds 2^44 by at most 2^12), then the quotient itself at the states'
// ends, around multiples of freq and on a random sample.
static void test_ans_div() {
  long checked = 0;
  for (uint32_t freq = 1; freq <= 4096; freq++) {
    uint64_t recip = hyd_ans_recip(freq);
    unsigned __int128 prod = (unsigned __int128)recip * freq;
    if (prod < ((unsigned __int128)1 << 44) ||
        prod - ((unsigned __int128)1 << 44) > (1u << 12)) {
      fprintf(stderr, "ans div: the reciprocal of %u is off\n", freq);
      exit(1);
    }
    std::vector<uint32_t> states = {0u, 1u, freq - 1, freq, 0xFFFFFFFFu,
                                    0xFFFFFFFEu, (freq << 20) - 1};
    uint32_t top = 0xFFFFFFFFu / freq;
    for (uint32_t q : {1u, 2u, top / 2, top - 1, top})
      for (int d = -1; d <= 1; d++)
        states.push_back((uint32_t)((uint64_t)q * freq + d));
    for (int k = 0; k < 2000; k++) states.push_back(rnd());
    for (uint32_t st : states) {
      if (hyd_ans_div(st, freq) != st / freq) {
        fprintf(stderr, "ans div: %u / %u gave %u\n", st, freq,
                hyd_ans_div(st, freq));
        exit(1);
      }
      checked++;
    }
  }
  printf("ans div ok (%ld quotients)\n", checked);
}

// Format-v4 LF residual stream: hybrid-uint-tokenized fields under one
// fixed 6-bit transport code; hyd_lf_decode must reconstruct the exact
// pack_signed values and land on the exact bit count.
static void test_lf_decode() {
  auto rev6 = [](uint32_t v) {
    uint32_t r = 0;
    for (int i = 0; i < 6; i++) r |= ((v >> i) & 1) << (5 - i);
    return r;
  };
  std::vector<uint16_t> lut(4096);
  for (uint32_t idx = 0; idx < 4096; idx++)
    lut[idx] = (uint16_t)(rev6(idx & 63) | (6 << 8));
  const long n = 5000;
  std::vector<uint32_t> vals(n), lfw;
  uint64_t cache = 0;
  int nbits = 0;
  long total = 0;
  for (long i = 0; i < n; i++) {
    uint32_t v = rnd() % ((i % 7 == 0) ? (1u << 20) : 16u);
    vals[i] = v;
    uint32_t tok, res;
    int rb;
    if (v < 16) {
      tok = v; res = 0; rb = 0;
    } else {
      int fl = 31 - __builtin_clz(v);
      rb = fl - 1;
      tok = 16 + (((uint32_t)(rb - 3) << 1) | ((v >> rb) & 1));
      res = v & ((1u << rb) - 1);
    }
    cache |= (uint64_t)rev6(tok) << nbits;
    nbits += 6;
    cache |= (uint64_t)res << nbits;
    nbits += rb;
    total += 6 + rb;
    while (nbits >= 32) {
      lfw.push_back((uint32_t)cache);
      cache >>= 32;
      nbits -= 32;
    }
  }
  if (nbits) lfw.push_back((uint32_t)cache);
  lfw.push_back(0);
  lfw.push_back(0);
  std::vector<uint32_t> out(n);
  long end = hyd_lf_decode(lfw.data(), lut.data(), n, total, out.data());
  if (end != total) {
    fprintf(stderr, "lf decode end %ld != %ld\n", end, total);
    exit(1);
  }
  for (long i = 0; i < n; i++)
    if (out[i] != vals[i]) {
      fprintf(stderr, "lf decode mismatch at %ld: %u != %u\n", i, out[i],
              vals[i]);
      exit(1);
    }
  printf("lf decode ok\n");

  // Corrupt streams must return -1 WITHOUT reading past the buffer's
  // one slack word (ADVICE r3: the old between-fields-only guard let a
  // mid-field advance dereference past the fetched words; ASAN verifies
  // the exact-size allocations here).
  {
    // every LUT entry: token 62 (rb = 26), code length 6 -> each field
    // is exactly 32 bits
    std::vector<uint16_t> lut62(4096, (uint16_t)(62 | (6 << 8)));
    // exactly 1 payload word + 1 slack word; claim 2 fields in 32 bits:
    // field 1 consumes all of max_bits, field 2 starts AT max_bits (the
    // old `>` check admitted it and peek12 read words[2])
    std::vector<uint32_t> tight{0x5A5A5A5Au, 0u};
    uint32_t o2[2] = {0, 0};
    if (hyd_lf_decode(tight.data(), lut62.data(), 2, 32, o2) != -1) {
      fprintf(stderr, "lf decode: field at max_bits not rejected\n");
      exit(1);
    }
    // mid-field overrun: max_bits 20 but the first field needs 32 bits
    // (code 6 + residue 26) -- must reject BEFORE read() runs off
    std::vector<uint32_t> tiny{0x12345678u, 0u};
    if (hyd_lf_decode(tiny.data(), lut62.data(), 1, 20, o2) != -1) {
      fprintf(stderr, "lf decode: mid-field overrun not rejected\n");
      exit(1);
    }
  }
  printf("lf decode corrupt ok\n");
}

// PNG row defilter (hyd_png_unfilter) against the PNG specification's
// filter definitions (PNG 2nd ed., section 9.2): with a the byte bpp to
// the left, b the byte above and c the byte above-left (0 where there is
// none, all of the prior row where there is no prior row), a filtered
// byte is Orig(x) - Pred(a, b, c) mod 256 with Pred 0 (None), a (Sub),
// b (Up), floor((a + b) / 2) (Average) or the Paeth predictor.  Each row
// is filtered here from the definitions and must come back as the
// original; random filtered bytes must reconstruct as the definitions
// say.  Rows are heap blocks of exactly n bytes, so ASAN sees any read
// or write past a row (n < bpp and n == 0 included).
static int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

static int png_pred(int filter, const uint8_t* recon, const uint8_t* prev,
                    long i, int bpp) {
  const int a = i >= bpp ? recon[i - bpp] : 0;
  const int b = prev ? prev[i] : 0;
  const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
  switch (filter) {
    case 1: return a;
    case 2: return b;
    case 3: return (a + b) / 2;
    case 4: return paeth(a, b, c);
    default: return 0;
  }
}

static void png_case(int filter, int bpp, long n, bool with_prev) {
  uint8_t* orig = new uint8_t[n];
  uint8_t* prev = with_prev ? new uint8_t[n] : nullptr;
  uint8_t* row = new uint8_t[n];
  uint8_t* want = new uint8_t[n];
  for (long i = 0; i < n; i++) {
    orig[i] = (uint8_t)rnd();
    if (prev) prev[i] = (uint8_t)rnd();
  }
  // forward filter from the definitions: predictors see original bytes
  for (long i = 0; i < n; i++)
    row[i] = (uint8_t)(orig[i] - png_pred(filter, orig, prev, i, bpp));
  if (hyd_png_unfilter(row, prev, n, bpp, filter) != 0) {
    fprintf(stderr, "png unfilter %d refused bpp=%d n=%ld\n", filter, bpp,
            n);
    exit(1);
  }
  if (n && memcmp(row, orig, n) != 0) {
    fprintf(stderr, "png unfilter %d round trip bpp=%d n=%ld prev=%d\n",
            filter, bpp, n, (int)with_prev);
    exit(1);
  }
  // random filtered bytes, reconstructed byte by byte as defined
  for (long i = 0; i < n; i++) row[i] = (uint8_t)rnd();
  for (long i = 0; i < n; i++)
    want[i] = (uint8_t)(row[i] + png_pred(filter, want, prev, i, bpp));
  hyd_png_unfilter(row, prev, n, bpp, filter);
  if (n && memcmp(row, want, n) != 0) {
    fprintf(stderr, "png unfilter %d random bpp=%d n=%ld prev=%d\n", filter,
            bpp, n, (int)with_prev);
    exit(1);
  }
  delete[] orig;
  delete[] prev;
  delete[] row;
  delete[] want;
}

static void test_png_unfilter() {
  // 1-4 channels of 8 bits (1, 2, 3, 4) and of 16 bits (2, 4, 6, 8)
  const int bpps[] = {1, 2, 3, 4, 6, 8};
  for (int filter = 0; filter <= 4; filter++)
    for (int bpp : bpps)
      for (int with_prev = 0; with_prev < 2; with_prev++) {
        for (long n = 0; n <= bpp; n++) png_case(filter, bpp, n, with_prev);
        for (int k = 0; k < 8; k++)
          png_case(filter, bpp, bpp * (1 + (long)(rnd() % 700)), with_prev);
      }
  uint8_t row[4] = {1, 2, 3, 4};
  if (hyd_png_unfilter(row, nullptr, 4, 1, 5) != -1) {
    fprintf(stderr, "png unfilter: filter 5 not refused\n");
    exit(1);
  }
  printf("png unfilter ok\n");
}
// Transport code tables (hyd_tok_build_tables): every row is a complete
// code (Kraft sum exactly 1) of lengths in [1, 12]; each of its 4096 LUT
// entries names the symbol whose codeword its index starts with (LSB
// first) and that symbol's length; a negative frequency, or INT64_MAX,
// is refused.  Rows: uniform, all zero, one spike, halving weights (the
// 12-bit cap), weights near 2^62, and random magnitudes.
static void test_tok_tables() {
  const int R = 10, A = 64, N = 4096;
  std::vector<int64_t> f(R * A);
  std::vector<int32_t> lens(R * A);
  std::vector<uint32_t> codes(R * A);
  std::vector<uint16_t> lut(R * N);
  bool capped = false;
  for (int iter = 0; iter < 40; iter++) {
    for (int k = 0; k < R; k++)
      for (int s = 0; s < A; s++) {
        int64_t& v = f[k * A + s];
        switch ((iter + k) % 6) {
          case 0: v = 777; break;
          case 1: v = 0; break;
          case 2: v = s == 5 ? (int64_t)1 << 40 : 0; break;
          case 3: v = s < 62 ? (int64_t)1 << (62 - s) : 1; break;
          case 4: v = ((int64_t)1 << 62) - (int64_t)(rnd() % 1000); break;
          default: v = (int64_t)(((uint64_t)rnd() << 16) >> (rnd() % 48));
        }
      }
    if (hyd_tok_build_tables(f.data(), lens.data(), codes.data(),
                             lut.data()) != 0) {
      fprintf(stderr, "tok tables: build %d failed\n", iter);
      exit(1);
    }
    for (int k = 0; k < R; k++) {
      uint64_t kraft = 0;
      for (int s = 0; s < A; s++) {
        const int32_t len = lens[k * A + s];
        if (len < 1 || len > 12 || codes[k * A + s] >> len) {
          fprintf(stderr, "tok tables: row %d symbol %d length %d\n", k, s,
                  len);
          exit(1);
        }
        capped |= len == 12;
        kraft += (uint64_t)1 << (12 - len);
      }
      if (kraft != (uint64_t)N) {
        fprintf(stderr, "tok tables: row %d Kraft sum %llu/4096\n", k,
                (unsigned long long)kraft);
        exit(1);
      }
      for (int i = 0; i < N; i++) {
        const uint16_t e = lut[k * N + i];
        const int s = e & 0xff, len = e >> 8;
        if (s >= A || len != lens[k * A + s] ||
            (uint32_t)(i & ((1 << len) - 1)) != codes[k * A + s]) {
          fprintf(stderr, "tok tables: row %d LUT entry %d = %u\n", k, i,
                  (unsigned)e);
          exit(1);
        }
      }
    }
  }
  if (!capped) {
    fprintf(stderr, "tok tables: no code reached 12 bits\n");
    exit(1);
  }
  const int64_t bad[2] = {-1, INT64_MAX};
  for (int64_t b : bad) {
    std::fill(f.begin(), f.end(), 1);
    f[3 * A + 17] = b;
    if (hyd_tok_build_tables(f.data(), lens.data(), codes.data(),
                             lut.data()) != -1) {
      fprintf(stderr, "tok tables: frequency %lld not refused\n",
              (long long)b);
      exit(1);
    }
  }
  printf("tok tables ok\n");
}

int main() {
  test_prefix_streams();
  test_hf_padded();
  test_hf_packed();
  test_encode_all_threads();
  test_ans_reverse_map();
  test_ans_div();
  test_lf_decode();
  test_png_unfilter();
  test_tok_tables();
  printf("selftest passed\n");
  return 0;
}
