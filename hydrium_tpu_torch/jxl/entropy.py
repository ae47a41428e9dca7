"""JPEG XL entropy coding: hybrid-uint tokenization, LZ77 RLE, cluster
maps, depth-limited prefix codes, and rANS with alias tables.

Pure-Python reference implementation, behaviorally equivalent to hydrium's
entropy coder (reference: src/libhydrium/entropy.c) so that outputs can be
byte-compared in differential tests.  The hot rANS emission path also has a
C++ implementation (csrc/host/serializer.cc) used by the encoder; this
module is the oracle it is tested against.

Key behaviors replicated (with reference citations):
- hybrid-uint split/msb/lsb tokenization           (entropy.c:427-444)
- repeat-only LZ77 with min_length 3, cap 127      (entropy.c:473-524)
- cluster map: simple <=3-bit, or MTF + nested
  prefix stream with LZ77 min_symbol 64            (entropy.c:108-167)
- depth-limited Huffman tree build                 (entropy.c:592-662)
- canonical prefix table, bit-reversed codes       (entropy.c:664-707)
- simple (<=4 symbol) prefix headers, tree_select  (entropy.c:869-923)
- complex two-level prefix length coding           (entropy.c:730-805)
- ANS frequency normalization to 1<<12             (entropy.c:267-301)
- ANS histogram serialization forms                (entropy.c:303-369)
- alias table construction                         (entropy.c:184-265)
- backwards rANS encode, interleaved state flushes (entropy.c:1064-1159)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .bitwriter import BitWriter, U32Table

ANS_TOTAL_LOG = 12
ANS_TOTAL = 1 << ANS_TOTAL_LOG
ANS_INITIAL_STATE = 0x130000

# Prefix codes for ANS histogram log-counts (entropy.c:35-38), indexed by
# log_count in 0..13: (symbol_bits, length).
ANS_DIST_PREFIX_LENGTHS = (
    (17, 5), (11, 4), (15, 4), (3, 4), (9, 4), (7, 4), (4, 3),
    (2, 3), (5, 3), (6, 3), (0, 3), (33, 6), (1, 7), (65, 7),
)

# Code-length-code zig-zag order and level-0 table (entropy.c:42-46).
PREFIX_ZIG_ZAG = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
PREFIX_LEVEL0_TABLE = ((0, 2), (7, 4), (3, 3), (2, 2), (1, 2), (15, 4))

MIN_SYMBOL_TABLE = U32Table(cpos=(224, 512, 4096, 8), upos=(0, 0, 0, 15))
MIN_LENGTH_TABLE = U32Table(cpos=(3, 4, 5, 9), upos=(0, 0, 2, 8))

LZ77_LEN_CONFIG = (7, 0, 0)  # split_exponent, msb_in_token, lsb_in_token


def fllog2(n: int) -> int:
    return n.bit_length() - 1


def cllog2(n: int) -> int:
    return fllog2(n) + (1 if n & (n - 1) else 0)


def pack_signed(v: int) -> int:
    """Zig-zag map int -> uint (math-functions.h:69-72)."""
    return (v << 1) if v >= 0 else ((-v << 1) - 1)


def bitswap32(b: int) -> int:
    """Reverse the bits of a 32-bit word."""
    b = ((b & 0x55555555) << 1) | ((b >> 1) & 0x55555555)
    b = ((b & 0x33333333) << 2) | ((b >> 2) & 0x33333333)
    b = ((b & 0x0F0F0F0F) << 4) | ((b >> 4) & 0x0F0F0F0F)
    b = ((b & 0x00FF00FF) << 8) | ((b >> 8) & 0x00FF00FF)
    return ((b & 0xFFFF) << 16) | (b >> 16)


def hybridize(symbol: int, cfg: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Hybrid-uint tokenization -> (token, residue, residue_bits).

    entropy.c:427-444."""
    split_exponent, msb_in_token, lsb_in_token = cfg
    split = 1 << split_exponent
    if symbol < split:
        return symbol, 0, 0
    n = fllog2(symbol) - lsb_in_token - msb_in_token
    low = symbol & ((1 << lsb_in_token) - 1)
    symbol >>= lsb_in_token
    residue = symbol & ((1 << n) - 1)
    symbol >>= n
    high = symbol & ((1 << msb_in_token) - 1)
    token = split + (
        low
        | (high << lsb_in_token)
        | ((n - split_exponent + lsb_in_token + msb_in_token)
           << (msb_in_token + lsb_in_token))
    )
    return token, residue, n


def write_hybrid_uint_config(bw: BitWriter, cfg: Tuple[int, int, int],
                             log_alphabet_size: int) -> None:
    """entropy.c:169-182."""
    split_exponent, msb_in_token, lsb_in_token = cfg
    bw.write(split_exponent, cllog2(1 + log_alphabet_size))
    if split_exponent == log_alphabet_size:
        return
    bw.write(msb_in_token, cllog2(1 + split_exponent))
    bw.write(lsb_in_token, cllog2(1 + split_exponent - msb_in_token))


def _write_ans_u8(bw: BitWriter, b: int) -> None:
    """Variable u8: bool, then 3-bit log, then log bits (entropy.c:71-78)."""
    bw.write_bool(b != 0)
    if not b:
        return
    l = fllog2(b)
    bw.write(l, 3)
    bw.write(b, l)


# ---------------------------------------------------------------------------
# Depth-limited Huffman (entropy.c:577-662)
# ---------------------------------------------------------------------------


def build_huffman_lengths(frequencies: Sequence[int], alphabet_size: int,
                          max_depth: int) -> List[int]:
    """Return code lengths via hydrium's in-array depth-limited Huffman.

    The exact tie-breaking and depth-targeting of the reference algorithm is
    reproduced so that code lengths (hence bitstreams) match byte-for-byte
    in differential tests (entropy.c:592-662)."""
    A = alphabet_size
    # Slots: [token(0 for internal, 1+idx for leaves), freq, depth, max_depth,
    #         left_slot, right_slot]
    tree = [[0, 0, 0, 0, -1, -1] for _ in range(2 * A - 1)]
    nz = 0
    for t in range(A):
        tree[t][0] = 1 + t
        tree[t][1] = frequencies[t]
        if frequencies[t]:
            nz += 1
    if nz == 0:
        raise ValueError("No nonzero frequencies")
    if max_depth < 0:
        max_depth = cllog2(A + 1)

    def compare(a, b) -> int:
        # (freq, token) ordering with zero-freq sorting first (entropy.c:577-581)
        if a[1] != b[1]:
            if b[1] == 0:
                return -1
            if a[1] == 0:
                return 1
            return a[1] - b[1]
        if b[0] == 0:
            return -1
        if a[0] == 0:
            return 1
        return a[0] - b[0]

    def collect(slot: int) -> int:
        if slot < 0:
            return 0
        e = tree[slot]
        e[2] += 1
        left = collect(e[4])
        right = collect(e[5])
        e[3] = max(e[2], left, right)
        return e[3]

    for k in range(A - 1):
        target = max_depth - cllog2(nz) + 1
        smallest = -1
        second = -1
        for j in range(2 * k, A + k):
            if tree[j][1] == 0 or tree[j][3] >= target:
                continue
            if smallest < 0 or compare(tree[j], tree[smallest]) < 0:
                second = smallest
                smallest = j
            elif second < 0 or compare(tree[j], tree[second]) < 0:
                second = j
        if smallest < 0:
            raise ValueError("couldn't find huffman merge target")
        tree[smallest], tree[2 * k] = tree[2 * k], tree[smallest]
        if second < 0:
            break
        if second == 2 * k:
            second = smallest
        smallest = 2 * k
        tree[second], tree[2 * k + 1] = tree[2 * k + 1], tree[second]
        second = smallest + 1
        entry = tree[A + k]
        entry[1] = tree[smallest][1] + tree[second][1]
        entry[4] = smallest
        entry[5] = second
        collect(A + k)
        nz -= 1

    lengths = [0] * A
    for e in tree:
        if e[0]:
            lengths[e[0] - 1] = e[2]
    return lengths


def build_prefix_table(lengths: Sequence[int],
                       alphabet_size: int) -> List[Tuple[int, int]]:
    """Canonical prefix table -> [(bit_reversed_code, length)] per symbol.

    Counting-sort by length (stable ascending symbol within a length), then
    canonical code assignment with 32-bit bit-reversal (entropy.c:664-707)."""
    counts = [0] * max(alphabet_size + 1, 16)
    for j in range(alphabet_size):
        counts[lengths[j]] += 1
    for j in range(1, alphabet_size + 1):
        counts[j] += counts[j - 1]
    pre = [(0, 0)] * alphabet_size
    for j in range(alphabet_size - 1, -1, -1):
        counts[lengths[j]] -= 1
        pre[counts[lengths[j]]] = (lengths[j], j)
    table = [(0, 0)] * alphabet_size
    code = 0
    for length, sym in pre:
        if not length:
            continue
        table[sym] = (bitswap32(code), length)
        code += 1 << (32 - length)
    if code and code != 1 << 32:
        raise ValueError("VLC codes do not add up")
    return table


def _flush_zeroes(bw: BitWriter, level1_table, num_zeroes: int) -> None:
    """Zero-run coding in the code-length stream (entropy.c:709-728)."""
    if num_zeroes >= 3:
        residues = []
        while num_zeroes > 10:
            new_num_zeroes = (num_zeroes + 13) // 8
            residues.append(num_zeroes - 8 * new_num_zeroes + 16)
            num_zeroes = new_num_zeroes
        residues.append(num_zeroes)
        for res in reversed(residues):
            bw.write(level1_table[17][0], level1_table[17][1])
            bw.write(res - 3, 3)
    elif num_zeroes:
        for _ in range(num_zeroes):
            bw.write(level1_table[0][0], level1_table[0][1])


def write_complex_prefix_lengths(bw: BitWriter, alphabet_size: int,
                                 lengths: Sequence[int]) -> None:
    """Two-level code-length coding, hskip=0 (entropy.c:730-805)."""
    bw.write(0, 2)  # hskip = 0

    level1_freqs = [0] * 18
    num_zeroes = 0
    for j in range(alphabet_size):
        code = lengths[j]
        if not code:
            num_zeroes += 1
            continue
        if num_zeroes >= 3:
            while num_zeroes > 10:
                level1_freqs[17] += 1
                num_zeroes = (num_zeroes + 13) // 8
            level1_freqs[17] += 1
        else:
            level1_freqs[0] += num_zeroes
        num_zeroes = 0
        level1_freqs[code] += 1

    level1_lengths = build_huffman_lengths(level1_freqs, 18, 5)

    total_code = 0
    for j in range(18):
        code = level1_lengths[PREFIX_ZIG_ZAG[j]]
        sym, ln = PREFIX_LEVEL0_TABLE[code]
        bw.write(sym, ln)
        if code:
            total_code += 32 >> code
        if total_code >= 32:
            break
    if total_code and total_code != 32:
        raise ValueError("level1 code total mismatch")

    level1_table = build_prefix_table(level1_lengths, 18)

    total_code = 0
    num_zeroes = 0
    for j in range(alphabet_size):
        code = lengths[j]
        if not code:
            num_zeroes += 1
            continue
        _flush_zeroes(bw, level1_table, num_zeroes)
        num_zeroes = 0
        bw.write(level1_table[code][0], level1_table[code][1])
        total_code += 32768 >> code
        if total_code == 32768:
            break
    _flush_zeroes(bw, level1_table, num_zeroes)


# ---------------------------------------------------------------------------
# ANS
# ---------------------------------------------------------------------------


def normalize_ans_frequencies(frequencies: List[int], alphabet_size: int) -> bool:
    """Normalize counts in-place so they sum to 1<<12.

    Returns True iff the distribution degenerates to all mass on the last
    symbol (the `uniq` case).  Replicates entropy.c:267-301 exactly,
    including the tail-reduction walk and the slot-0 deficit dump."""
    total = sum(frequencies[:alphabet_size])
    if not total:
        raise ValueError("all-zero ANS frequencies")
    new_total = 0
    for k in range(alphabet_size):
        if not frequencies[k]:
            continue
        f = ((frequencies[k] << ANS_TOTAL_LOG) // total) & 0xFFFF
        frequencies[k] = f if f else 1
        new_total += frequencies[k]
    j = alphabet_size - 1
    while new_total > ANS_TOTAL:
        diff = new_total - ANS_TOTAL
        if diff < frequencies[j]:
            frequencies[j] -= diff
            new_total -= diff
            break
        elif frequencies[j] > 1:
            new_total -= frequencies[j] - 1
            frequencies[j] = 1
        j -= 1
    frequencies[0] += ANS_TOTAL - new_total
    return frequencies[alphabet_size - 1] == ANS_TOTAL


def write_ans_frequencies(bw: BitWriter, frequencies: Sequence[int],
                          alphabet_size: int) -> None:
    """Serialize one cluster's normalized histogram (entropy.c:303-369)."""
    if not alphabet_size:
        bw.write(0x1, 2)       # simple dist form
        _write_ans_u8(bw, 0)
        return

    nz1 = -1
    nz2 = -1
    nzc = 0
    for k in range(alphabet_size):
        if frequencies[k] == ANS_TOTAL:
            bw.write(0x1, 2)
            _write_ans_u8(bw, k)
            return
        if not frequencies[k]:
            continue
        nzc += 1
        if nzc > 2:
            break
        if nz1 < 0:
            nz1 = k
        elif frequencies[nz1] + frequencies[k] == ANS_TOTAL:
            nz2 = k
            break

    if nz1 >= 0 and nz2 >= 0:
        bw.write(0x3, 2)       # dual-peak form
        _write_ans_u8(bw, nz1)
        _write_ans_u8(bw, nz2)
        bw.write(frequencies[nz1], 12)
        return

    # general form: not simple/flat, len=3, shift=13
    bw.write(0, 2)
    bw.write(0x7, 3)
    bw.write(0x6, 3)
    _write_ans_u8(bw, alphabet_size - 3)
    log_counts = []
    omit_pos = 0
    omit_log = 0
    for k in range(alphabet_size):
        lc = 1 + fllog2(frequencies[k]) if frequencies[k] else 0
        log_counts.append(lc)
        sym, ln = ANS_DIST_PREFIX_LENGTHS[lc]
        bw.write(sym, ln)
        if lc > omit_log:
            omit_log = lc
            omit_pos = k
    for k in range(alphabet_size):
        if k == omit_pos or log_counts[k] <= 1:
            continue
        bw.write(frequencies[k], log_counts[k] - 1)


@dataclass
class AliasEntry:
    count: int = 0
    cutoffs: List[int] = field(default_factory=list)
    offsets: List[int] = field(default_factory=list)
    original: List[int] = field(default_factory=list)


def generate_alias_mapping(frequencies: Sequence[int], alphabet_size: int,
                           log_alphabet_size: int,
                           uniq_pos: int) -> List[AliasEntry]:
    """Build the ANS alias table (entropy.c:184-265).

    uniq_pos >= 0 selects the degenerate single-symbol layout."""
    log_bucket_size = ANS_TOTAL_LOG - log_alphabet_size
    bucket_size = 1 << log_bucket_size
    table_size = 1 << log_alphabet_size
    symbols = [0] * table_size
    cutoffs = [0] * table_size
    offsets = [0] * table_size
    alias_table = [AliasEntry() for _ in range(alphabet_size)]

    if uniq_pos >= 0:
        for i in range(table_size):
            symbols[i] = uniq_pos
            offsets[i] = i * bucket_size
        alias_table[uniq_pos].count = table_size
    else:
        underfull: List[int] = []
        overfull: List[int] = []
        for pos in range(alphabet_size):
            cutoffs[pos] = frequencies[pos]
            if cutoffs[pos] < bucket_size:
                underfull.append(pos)
            elif cutoffs[pos] > bucket_size:
                overfull.append(pos)
        for i in range(alphabet_size, table_size):
            underfull.append(i)
        while overfull:
            if not underfull:
                raise ValueError("empty underfull during alias table gen")
            u = underfull.pop()
            o = overfull.pop()
            by = bucket_size - cutoffs[u]
            cutoffs[o] -= by
            offsets[u] = cutoffs[o]
            symbols[u] = o
            if cutoffs[o] < bucket_size:
                underfull.append(o)
            elif cutoffs[o] > bucket_size:
                overfull.append(o)
        for sym in range(table_size):
            if cutoffs[sym] == bucket_size:
                symbols[sym] = sym
                cutoffs[sym] = 0
                offsets[sym] = 0
            else:
                offsets[sym] -= cutoffs[sym]
            alias_table[symbols[sym]].count += 1

    for sym in range(alphabet_size):
        e = alias_table[sym]
        e.cutoffs = [cutoffs[sym]]
        e.offsets = [0]
        e.original = [sym]
    for i in range(table_size):
        e = alias_table[symbols[i]]
        e.cutoffs.append(cutoffs[i])
        e.offsets.append(offsets[i])
        e.original.append(i)
    return alias_table


def ans_encode_symbols(tokens: Sequence[int], clusters: Sequence[int],
                       residues: Sequence[int], residue_bits: Sequence[int],
                       frequencies: Sequence[Sequence[int]],
                       alias_tables: Sequence[Sequence[AliasEntry]],
                       log_alphabet_size: int, bw: BitWriter) -> None:
    """Backwards rANS encode + forward interleaved emission.

    Replicates the two-pass scheme of entropy.c:1064-1159: the backwards
    pass records 16-bit state flushes with symbol-distance tags; the
    forward pass replays them interleaved with residue bits."""
    n = len(tokens)
    log_bucket_size = ANS_TOTAL_LOG - log_alphabet_size
    pos_mask = (1 << log_bucket_size) - 1

    state = ANS_INITIAL_STATE
    flushes: List[Tuple[int, int]] = []  # (diff, value) stack
    last_push = n
    last_value = 0
    for p in range(n - 1, -1, -1):
        symbol = tokens[p]
        cluster = clusters[p]
        freq = frequencies[cluster][symbol]
        if (state >> 20) >= freq:
            if last_push != n:
                flushes.append((last_push - p, last_value))
            last_push = p
            last_value = state & 0xFFFF
            state >>= 16
        div = state // freq
        offset = state - div * freq
        alias = alias_tables[cluster][symbol]
        for j in range(alias.count + 1):
            pos = offset - alias.offsets[j]
            k = pos - alias.cutoffs[j]
            if 0 <= pos <= pos_mask and (k >= 0 if j > 0 else k < 0):
                i = alias.original[j]
                break
        else:
            raise ValueError("alias table lookup failed")
        state = (div << 12) | (i << log_bucket_size) | pos

    if last_push != n:
        flushes.append((last_push, last_value))
    flushes.append((0, (state >> 16) & 0xFFFF))
    flushes.append((0, state & 0xFFFF))

    last_pop = 0
    for p in range(n):
        while flushes:
            diff, value = flushes[-1]
            if p - last_pop >= diff:
                flushes.pop()
                bw.write(value, 16)
                last_pop = p
            else:
                break
        bw.write(residues[p], residue_bits[p])


def write_cluster_map(bw: BitWriter, cluster_map: Sequence[int],
                      num_dists: int, num_clusters: int) -> None:
    """Context->cluster map coding: simple <=3-bit form or MTF + nested
    prefix stream (entropy.c:108-167)."""
    if num_dists == 1:
        return
    nbits = cllog2(num_clusters)
    if nbits <= 3 and num_dists * nbits <= 32:
        bw.write_bool(True)
        bw.write(nbits, 2)
        for c in cluster_map[:num_dists]:
            bw.write(int(c), nbits)
        return
    bw.write_bool(False)
    bw.write_bool(True)  # use_mtf
    nested = EntropyStream([0], 1, custom_configs=True, lz77_min_symbol=64)
    nested.set_hybrid_config(0, 0, 4, 1, 0)
    mtf = list(range(256))
    for j in range(num_dists):
        index = mtf.index(cluster_map[j])
        nested.send_symbol(0, index)
        if index:
            mtf.insert(0, mtf.pop(index))
    nested.prefix_finalize(bw)


# ---------------------------------------------------------------------------
# EntropyStream
# ---------------------------------------------------------------------------


class EntropyStream:
    """A tokenized symbol stream plus its header/emission machinery.

    Equivalent to HYDEntropyStream (entropy.h:34-65).  Symbols are stored
    as parallel lists of (cluster, token, residue, residue_bits)."""

    def __init__(self, cluster_map: Sequence[int], num_dists: int,
                 custom_configs: bool = False, lz77_min_symbol: int = 0,
                 modular: bool = False) -> None:
        if not num_dists:
            raise ValueError("zero dist count")
        self.lz77_min_symbol = lz77_min_symbol
        self.lz77_min_length = 3 if lz77_min_symbol else 0
        self.modular = modular
        if lz77_min_symbol:
            num_dists += 1
        self.num_dists = num_dists
        self.cluster_map = list(cluster_map[: num_dists - (1 if lz77_min_symbol else 0)])
        self.num_clusters = (max(self.cluster_map) + 1) if self.cluster_map else 0
        if self.num_clusters > num_dists:
            raise ValueError("more clusters than dists")
        if lz77_min_symbol:
            self.cluster_map.append(self.num_clusters)
            self.num_clusters += 1

        self.configs: List[Tuple[int, int, int]] = [(0, 0, 0)] * self.num_clusters
        if not custom_configs:
            for c in range(self.num_clusters - (1 if lz77_min_symbol else 0)):
                self.configs[c] = (4, 1, 1)
            if lz77_min_symbol:
                self.configs[self.num_clusters - 1] = (7, 0, 0)

        self.clusters: List[int] = []
        self.tokens: List[int] = []
        self.residues: List[int] = []
        self.residue_bits: List[int] = []
        self.alphabet_sizes = [0] * self.num_clusters
        self.max_alphabet_size = 0
        self.wrote_stream_header = False

        # LZ77 RLE state (entropy.c:50-55)
        self._last_symbol = 0
        self._last_dist = 0
        self._rle_count = 0

        # populated by header/frequency passes
        self.frequencies: List[Optional[List[int]]] = [None] * self.num_clusters
        self.vlc_tables: List[Optional[List[Tuple[int, int]]]] = [None] * self.num_clusters
        self.alias_tables: List[Optional[List[AliasEntry]]] = [None] * self.num_clusters

    # -- symbol ingestion ----------------------------------------------

    def set_hybrid_config(self, min_cluster: int, to_cluster: int,
                          split_exponent: int, msb_in_token: int,
                          lsb_in_token: int) -> None:
        c = min_cluster
        while (not to_cluster or c < to_cluster) and c < self.num_clusters:
            self.configs[c] = (split_exponent, msb_in_token, lsb_in_token)
            c += 1

    @property
    def symbol_count(self) -> int:
        return len(self.tokens)

    def _push(self, cluster: int, token: int, residue: int, bits: int) -> None:
        if self.wrote_stream_header:
            raise RuntimeError("illegal send after stream header")
        self.clusters.append(cluster)
        self.tokens.append(token)
        self.residues.append(residue)
        self.residue_bits.append(bits)
        if token + 1 > self.max_alphabet_size:
            self.max_alphabet_size = token + 1
        if token + 1 > self.alphabet_sizes[cluster]:
            self.alphabet_sizes[cluster] = token + 1

    def _send0(self, dist: int, symbol: int) -> None:
        cluster = self.cluster_map[dist]
        token, residue, bits = hybridize(symbol, self.configs[cluster])
        self._push(cluster, token, residue, bits)

    def _flush_lz77(self) -> None:
        last_symbol = self._last_symbol - 1
        if self._rle_count > self.lz77_min_length:
            repeat_count = self._rle_count - self.lz77_min_length
            token, residue, bits = hybridize(repeat_count, LZ77_LEN_CONFIG)
            cluster = self.cluster_map[self._last_dist]
            self._push(cluster, token + self.lz77_min_symbol, residue, bits)
            self._send0(self.num_dists - 1, 1 if self.modular else 0)
        elif self._last_symbol and self._rle_count:
            for _ in range(self._rle_count):
                self._send0(self._last_dist, last_symbol)
        self._rle_count = 0

    def send_symbol(self, dist: int, symbol: int) -> None:
        """entropy.c:502-524."""
        if not self.lz77_min_symbol:
            self._send0(dist, symbol)
            return
        if (self._last_symbol == symbol + 1
                and self.cluster_map[self._last_dist] == self.cluster_map[dist]
                and self._rle_count < 127):
            self._rle_count += 1
            return
        self._flush_lz77()
        self._last_symbol = symbol + 1
        self._last_dist = dist
        self._send0(dist, symbol)

    def send_tokenized(self, clusters, tokens, residues, residue_bits) -> None:
        """Bulk-append pre-tokenized symbols (device-plane fast path).

        Only valid for streams without LZ77."""
        assert not self.lz77_min_symbol
        self.clusters.extend(int(c) for c in clusters)
        self.tokens.extend(int(t) for t in tokens)
        self.residues.extend(int(r) for r in residues)
        self.residue_bits.extend(int(b) for b in residue_bits)
        for c, t in zip(clusters, tokens):
            c, t = int(c), int(t)
            if t + 1 > self.max_alphabet_size:
                self.max_alphabet_size = t + 1
            if t + 1 > self.alphabet_sizes[c]:
                self.alphabet_sizes[c] = t + 1

    # -- header common --------------------------------------------------

    def _count_frequencies(self, cluster_from: int, cluster_to: int,
                           symbol_from: int, symbol_count: int) -> None:
        """entropy.c:526-544."""
        for c in range(cluster_from, min(self.num_clusters, cluster_to)):
            if self.alphabet_sizes[c]:
                self.frequencies[c] = [0] * self.alphabet_sizes[c]
        end = min(len(self.tokens), symbol_from + symbol_count)
        for p in range(symbol_from, end):
            c = self.clusters[p]
            if cluster_from <= c < cluster_to:
                self.frequencies[c][self.tokens[p]] += 1

    def _write_cluster_map(self, bw: BitWriter) -> None:
        write_cluster_map(bw, self.cluster_map, self.num_dists,
                          self.num_clusters)

    def _stream_header_common(self, bw: BitWriter, log_alphabet_size: int) -> None:
        """entropy.c:546-575."""
        bw.write_bool(bool(self.lz77_min_symbol))
        if self.lz77_min_symbol:
            self._flush_lz77()
            bw.write_u32(MIN_SYMBOL_TABLE, self.lz77_min_symbol)
            bw.write_u32(MIN_LENGTH_TABLE, self.lz77_min_length)
            write_hybrid_uint_config(bw, LZ77_LEN_CONFIG, 8)
        self._write_cluster_map(bw)
        bw.write_bool(not log_alphabet_size)  # use_prefix_codes
        if log_alphabet_size:
            bw.write(log_alphabet_size - 5, 2)
        for c in range(self.num_clusters):
            write_hybrid_uint_config(
                bw, self.configs[c],
                log_alphabet_size if log_alphabet_size else 15)

    # -- prefix path ----------------------------------------------------

    def prefix_write_header(self, bw: BitWriter) -> None:
        """entropy.c:807-941."""
        self._stream_header_common(bw, 0)
        self._count_frequencies(0, self.num_clusters, 0, len(self.tokens))

        # per-cluster alphabet sizes
        for c in range(self.num_clusters):
            size = self.alphabet_sizes[c]
            if size <= 1:
                bw.write_bool(False)
                continue
            bw.write_bool(True)
            n = fllog2(size - 1)
            bw.write(n, 4)
            bw.write(size - 1, n)

        for c in range(self.num_clusters):
            alphabet_size = self.alphabet_sizes[c]
            if alphabet_size <= 1:
                self.vlc_tables[c] = [(0, 0)] * max(alphabet_size, 1)
                continue
            freqs = self.frequencies[c]
            lengths = build_huffman_lengths(freqs, alphabet_size, 15)
            present = [j for j in range(alphabet_size) if lengths[j]]
            nsym = len(present)

            if nsym > 4:
                write_complex_prefix_lengths(bw, alphabet_size, lengths)
                self.vlc_tables[c] = build_prefix_table(lengths, alphabet_size)
                continue

            tokens = [[j, lengths[j]] for j in present[:4]]
            if nsym == 0:
                nsym = 1
                tokens = [[alphabet_size - 1, 0]]

            bw.write(1, 2)  # hskip = 1 => simple code
            bw.write(nsym - 1, 2)
            las = cllog2(alphabet_size)
            if nsym == 3 and tokens[0][1] != 1:
                if tokens[1][1] == 1:
                    tokens[0], tokens[1] = tokens[1], tokens[0]
                else:
                    tokens[0], tokens[2] = tokens[2], tokens[0]
            tree_select = False
            if nsym == 4:
                tree_select = any(t[1] != 2 for t in tokens)
                if tree_select and tokens[0][1] != 1:
                    if tokens[1][1] == 1:
                        tokens[0], tokens[1] = tokens[1], tokens[0]
                    elif tokens[2][1] == 1:
                        tokens[0], tokens[2] = tokens[2], tokens[0]
                    else:
                        tokens[0], tokens[3] = tokens[3], tokens[0]
                if tree_select and tokens[1][1] != 2:
                    if tokens[2][1] == 2:
                        tokens[1], tokens[2] = tokens[2], tokens[1]
                    else:
                        tokens[1], tokens[3] = tokens[3], tokens[1]
            for t in tokens[:nsym]:
                bw.write(t[0], las)
            if nsym == 4:
                bw.write_bool(tree_select)
            self.vlc_tables[c] = build_prefix_table(lengths, alphabet_size)

        self.wrote_stream_header = True

    def prefix_write_symbols(self, bw: BitWriter, symbol_start: int,
                             symbol_count: int) -> None:
        """entropy.c:1003-1021."""
        for p in range(symbol_start, symbol_start + symbol_count):
            table = self.vlc_tables[self.clusters[p]]
            code, length = table[self.tokens[p]]
            bw.write(code, length)
            bw.write(self.residues[p], self.residue_bits[p])

    def prefix_finalize(self, bw: BitWriter) -> None:
        self.prefix_write_header(bw)
        self.prefix_write_symbols(bw, 0, len(self.tokens))

    # -- ANS path -------------------------------------------------------

    @property
    def log_alphabet_size(self) -> int:
        return max(cllog2(self.max_alphabet_size), 5)

    def ans_prepare_frequencies(self, cluster_from: int, cluster_to: int,
                                symbol_from: int, symbol_count: int) -> None:
        """entropy.c:943-978."""
        self._count_frequencies(cluster_from, cluster_to, symbol_from,
                                symbol_count)
        las = self.log_alphabet_size
        for c in range(cluster_from, min(self.num_clusters, cluster_to)):
            if not self.alphabet_sizes[c]:
                continue
            uniq = normalize_ans_frequencies(self.frequencies[c],
                                             self.alphabet_sizes[c])
            self.alias_tables[c] = generate_alias_mapping(
                self.frequencies[c], self.alphabet_sizes[c], las,
                self.alphabet_sizes[c] - 1 if uniq else -1)

    def ans_write_header(self, bw: BitWriter) -> None:
        """entropy.c:980-1001."""
        self._stream_header_common(bw, self.log_alphabet_size)
        for c in range(self.num_clusters):
            write_ans_frequencies(bw, self.frequencies[c] or [],
                                  self.alphabet_sizes[c])
        self.wrote_stream_header = True

    def ans_write_symbols(self, bw: BitWriter, symbol_offset: int,
                          symbol_count: int) -> None:
        s = slice(symbol_offset, symbol_offset + symbol_count)
        ans_encode_symbols(self.tokens[s], self.clusters[s],
                           self.residues[s], self.residue_bits[s],
                           self.frequencies, self.alias_tables,
                           self.log_alphabet_size, bw)
