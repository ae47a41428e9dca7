"""Entropy decoding of a JPEG XL codestream (ISO/IEC 18181-1 annex C):
hybrid-uint configurations, context maps, Brotli-style prefix codes,
ANS histograms with their alias tables, and LZ77 runs.

Written from the format, for the subset the encoder under test writes;
what lies outside it raises ParseFault."""

from __future__ import annotations

from typing import List, Tuple

from .bits import BitReader, ParseFault

ANS_LOG = 12
ANS_TOTAL = 1 << ANS_LOG
ANS_FINAL_STATE = 0x130000

# log-count prefix code of an ANS histogram: log count -> (bits, length)
_LOGCOUNT_CODE = ((17, 5), (11, 4), (15, 4), (3, 4), (9, 4), (7, 4), (4, 3),
                  (2, 3), (5, 3), (6, 3), (0, 3), (33, 6), (1, 7), (65, 7))
# code-length code: order of its 18 lengths, and each length's code
_CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_CL_LEN_CODE = ((0, 2), (7, 4), (3, 3), (2, 2), (1, 2), (15, 4))

_LZ77_MIN_SYMBOL = ((224, 0), (512, 0), (4096, 0), (8, 15))
_LZ77_MIN_LENGTH = ((3, 0), (4, 0), (5, 2), (9, 8))


def _lookup(codes, width: int) -> list:
    """A 2**width table from {value: (bits, length)} of a prefix-free
    LSB-first code: entry -> (value, length)."""
    table = [None] * (1 << width)
    for value, (bits, length) in codes.items():
        for fill in range(0, 1 << width, 1 << length):
            idx = bits | fill
            if table[idx] is not None:
                raise ValueError("code is not prefix-free")
            table[idx] = (value, length)
    return table


_LOGCOUNT_TABLE = _lookup(dict(enumerate(_LOGCOUNT_CODE)), 7)
_CL_LEN_TABLE = _lookup(dict(enumerate(_CL_LEN_CODE)), 4)


def read_hybrid_config(br: BitReader, log_alpha: int) -> Tuple[int, int, int]:
    split = br.read((log_alpha).bit_length())
    if split > log_alpha:
        raise ParseFault("hybrid uint split exponent past the alphabet")
    if split == log_alpha:
        return split, 0, 0
    msb = br.read(split.bit_length())
    if msb > split:
        raise ParseFault("hybrid uint msb_in_token")
    lsb = br.read((split - msb).bit_length())
    if msb + lsb > split:
        raise ParseFault("hybrid uint lsb_in_token")
    return split, msb, lsb


def hybrid_value(br: BitReader, cfg, token: int) -> int:
    split_exp, msb, lsb = cfg
    split = 1 << split_exp
    if token < split:
        return token
    nbits = (split_exp - (msb + lsb)
             + ((token - split) >> (msb + lsb)))
    if nbits > 32:
        raise ParseFault("hybrid uint wider than 32 bits")
    low = token & ((1 << lsb) - 1)
    token >>= lsb
    bits = br.read(nbits)
    return ((((1 << msb) | (token & ((1 << msb) - 1))) << nbits
             | bits) << lsb) | low


def canonical_table(lengths: List[int]):
    """(table, width) of the canonical prefix code with these lengths,
    its codes stored bit-reversed (first bit lowest)."""
    used = [(ln, s) for s, ln in enumerate(lengths) if ln]
    if len(used) == 1:
        return [(used[0][1], 0)], 0
    width = max(ln for ln, _ in used)
    codes = {}
    code = 0
    prev = 0
    for ln, s in sorted(used):
        code <<= ln - prev
        prev = ln
        codes[s] = (int(format(code, f"0{ln}b")[::-1], 2), ln)
        code += 1
    if code != 1 << prev:
        raise ParseFault("prefix code lengths do not fill the code space")
    return _lookup(codes, width), width


def read_prefix_code(br: BitReader, alphabet: int):
    hskip = br.read(2)
    if hskip == 1:
        nsym = br.read(2) + 1
        abits = (alphabet - 1).bit_length()
        syms = [br.read(abits) for _ in range(nsym)]
        if len(set(syms)) != nsym or max(syms) >= alphabet:
            raise ParseFault("simple prefix code symbols")
        if nsym == 1:
            return [(syms[0], 0)], 0
        lens = {2: (1, 1), 3: (1, 2, 2)}.get(nsym)
        if nsym == 4:
            lens = (1, 2, 3, 3) if br.read(1) else (2, 2, 2, 2)
        lengths = [0] * alphabet
        for s, ln in zip(syms, lens):
            lengths[s] = ln
        return canonical_table(lengths)
    cl = [0] * 18
    space, ncodes = 32, 0
    for i in range(hskip, 18):
        v, ln = _CL_LEN_TABLE[br.peek(4)]
        br.skip(ln)
        cl[_CL_ORDER[i]] = v
        if v:
            space -= 32 >> v
            ncodes += 1
            if space <= 0:
                break
    if not (ncodes == 1 or space == 0):
        raise ParseFault("code-length code does not fill its space")
    cl_table, cl_width = canonical_table(cl)
    lengths = [0] * alphabet
    sym, prev, repeat, repeat_len, space = 0, 8, 0, 0, 32768
    while sym < alphabet and space > 0:
        code, ln = cl_table[br.peek(cl_width)]
        br.skip(ln)
        if code < 16:
            lengths[sym] = code
            sym += 1
            repeat = 0
            if code:
                prev = code
                space -= 32768 >> code
            continue
        extra, new_len = (2, prev) if code == 16 else (3, 0)
        if repeat_len != new_len:
            repeat, repeat_len = 0, new_len
        old = repeat
        if repeat > 0:
            repeat = (repeat - 2) << extra
        repeat += br.read(extra) + 3
        delta = repeat - old
        if sym + delta > alphabet:
            raise ParseFault("code-length repeat past the alphabet")
        for _ in range(delta):
            lengths[sym] = new_len
            sym += 1
        if new_len:
            space -= delta * (32768 >> new_len)
    if space != 0:
        raise ParseFault("prefix code lengths do not fill the code space")
    return canonical_table(lengths)


def read_ans_histogram(br: BitReader, log_alpha: int) -> List[int]:
    if br.read(1):                       # simple: one or two symbols
        if br.read(1):
            s0, s1 = br.read_u8(), br.read_u8()
            if s0 == s1:
                raise ParseFault("two-symbol histogram repeats its symbol")
            counts = [0] * (max(s0, s1) + 1)
            counts[s0] = br.read(ANS_LOG)
            counts[s1] = ANS_TOTAL - counts[s0]
        else:
            s0 = br.read_u8()
            counts = [0] * (s0 + 1)
            counts[s0] = ANS_TOTAL
    elif br.read(1):                     # flat
        n = br.read_u8() + 1
        counts = [ANS_TOTAL // n + (1 if i < ANS_TOTAL % n else 0)
                  for i in range(n)]
    else:
        ln = 0
        while ln < 3 and br.read(1):
            ln += 1
        shift = br.read(ln) + (1 << ln) - 1
        if shift > 13:
            raise ParseFault("histogram shift past 13")
        n = br.read_u8() + 3
        logc = []
        for _ in range(n):
            lc, w = _LOGCOUNT_TABLE[br.peek(7)]
            br.skip(w)
            if lc == 13:
                raise ParseFault("run-length log counts (not written by "
                                 "the encoder under test)")
            logc.append(lc)
        omit = max(range(n), key=lambda i: (logc[i], -i))
        counts = [0] * n
        for i, lc in enumerate(logc):
            if i == omit or lc == 0:
                continue
            if lc == 1:
                counts[i] = 1
                continue
            bc = max(0, min(lc - 1, shift - ((ANS_LOG - (lc - 1)) >> 1)))
            counts[i] = (1 << (lc - 1)) + (br.read(bc) << (lc - 1 - bc))
        rest = ANS_TOTAL - sum(counts)
        if rest <= 0:
            raise ParseFault("histogram counts exceed 4096")
        counts[omit] = rest
    if len(counts) > 1 << log_alpha or sum(counts) != ANS_TOTAL:
        raise ParseFault("histogram does not fit the alphabet or sum")
    return counts


def alias_lists(counts: List[int], log_alpha: int):
    """Per 12-bit state slot: (symbol, frequency, offset) lists of the
    alias table of 18181-1 C.2.6."""
    d = list(counts)
    while d and d[-1] == 0:
        d.pop()
    if not d:
        d = [ANS_TOTAL]
    size = 1 << log_alpha
    log_entry = ANS_LOG - log_alpha
    entry = 1 << log_entry
    if ANS_TOTAL in d:
        s = d.index(ANS_TOTAL)
        return [s] * ANS_TOTAL, [ANS_TOTAL] * ANS_TOTAL, list(range(ANS_TOTAL))
    cutoffs = d + [0] * (size - len(d))
    right = [0] * size
    offs = [0] * size
    over = [i for i in range(len(d)) if cutoffs[i] > entry]
    under = [i for i in range(len(d)) if cutoffs[i] < entry]
    under += list(range(len(d), size))
    while over:
        o = over.pop()
        if not under:
            raise ParseFault("alias table: no underfull bucket")
        u = under.pop()
        cutoffs[o] -= entry - cutoffs[u]
        right[u] = o
        offs[u] = cutoffs[o]
        if cutoffs[o] < entry:
            under.append(o)
        elif cutoffs[o] > entry:
            over.append(o)
    dd = d + [0] * (size - len(d))
    sym, freq, off = [0] * ANS_TOTAL, [0] * ANS_TOTAL, [0] * ANS_TOTAL
    for i in range(size):
        cut = 0 if cutoffs[i] == entry else cutoffs[i]
        if cutoffs[i] == entry:
            right[i], offs[i] = i, 0
        else:
            offs[i] -= cutoffs[i]
        for pos in range(entry):
            r = (i << log_entry) | pos
            if pos >= cut:
                sym[r], freq[r], off[r] = right[i], dd[right[i]], offs[i] + pos
            else:
                sym[r], freq[r], off[r] = i, dd[i], pos
    return sym, freq, off


def read_cluster_map(br: BitReader, num_dists: int) -> List[int]:
    if br.read(1):
        nbits = br.read(2)
        cmap = [br.read(nbits) for _ in range(num_dists)]
    else:
        use_mtf = br.read(1)
        nested = EntropyDecoder(br, 1)
        nested.begin()
        cmap = [nested.value(0) for _ in range(num_dists)]
        nested.end("context map")
        if use_mtf:
            mtf = list(range(256))
            out = []
            for idx in cmap:
                if idx >= 256:
                    raise ParseFault("move-to-front index past 255")
                v = mtf.pop(idx)
                mtf.insert(0, v)
                out.append(v)
            cmap = out
    if max(cmap) >= 256:
        raise ParseFault("more than 256 clusters")
    return cmap


class EntropyDecoder:
    """One entropy-coded stream: its header is read on construction, its
    values by value(ctx) between begin() and end()."""

    def __init__(self, br: BitReader, num_dists: int,
                 dist_multiplier: int = 0) -> None:
        self.br = br
        self.dist_multiplier = dist_multiplier
        self.lz77 = br.read(1)
        if self.lz77:
            self.min_symbol = br.read_u32(_LZ77_MIN_SYMBOL)
            self.min_length = br.read_u32(_LZ77_MIN_LENGTH)
            self.len_cfg = read_hybrid_config(br, 8)
            num_dists += 1
        self.num_dists = num_dists
        self.cmap = read_cluster_map(br, num_dists) if num_dists > 1 else [0]
        n = max(self.cmap) + 1
        self.prefix = br.read(1)
        self.log_alpha = 15 if self.prefix else 5 + br.read(2)
        self.cfg = [read_hybrid_config(br, self.log_alpha) for _ in range(n)]
        if self.prefix:
            sizes = []
            for _ in range(n):
                if br.read(1):
                    k = br.read(4)
                    sizes.append(1 + (1 << k) + br.read(k))
                else:
                    sizes.append(1)
            self.tables = [read_prefix_code(br, a) if a > 1 else ([(0, 0)], 0)
                           for a in sizes]
        else:
            self.ans = [alias_lists(read_ans_histogram(br, self.log_alpha),
                                    self.log_alpha) for _ in range(n)]
        self.state = 0
        self.window: List[int] = []
        self.copies = 0
        self.copy_dist = 0

    def begin(self) -> None:
        if not self.prefix:
            self.state = self.br.read(32)

    def end(self, what: str) -> None:
        if self.copies:
            raise ParseFault(f"{what}: an LZ77 copy runs past the stream")
        if not self.prefix and self.state != ANS_FINAL_STATE:
            raise ParseFault(f"{what}: ANS final state {self.state:#x}")

    def token(self, cluster: int) -> int:
        br = self.br
        if self.prefix:
            table, width = self.tables[cluster]
            sym, ln = table[br.peek(width)]
            br.skip(ln)
            return sym
        sym_l, freq_l, off_l = self.ans[cluster]
        s = self.state
        r = s & 0xFFF
        s = freq_l[r] * (s >> 12) + off_l[r]
        if s < 0x10000:
            s = (s << 16) | br.read(16)
        self.state = s
        return sym_l[r]

    def value(self, ctx: int) -> int:
        if self.copies:
            self.copies -= 1
            v = self.window[-self.copy_dist]
            self.window.append(v)
            return v
        cluster = self.cmap[ctx]
        tok = self.token(cluster)
        if self.lz77 and tok >= self.min_symbol:
            n = (hybrid_value(self.br, self.len_cfg, tok - self.min_symbol)
                 + self.min_length)
            dc = self.cmap[self.num_dists - 1]
            dv = hybrid_value(self.br, self.cfg[dc], self.token(dc))
            if self.dist_multiplier == 0:
                dist = dv + 1
            elif dv == 1:
                dist = 1
            elif dv == 0:
                dist = self.dist_multiplier
            elif dv >= 120:
                dist = dv - 119
            else:
                raise ParseFault("LZ77 special distance not written by the "
                                 "encoder under test")
            if dist > len(self.window) or dist < 1:
                raise ParseFault("LZ77 distance before the stream's start")
            self.copy_dist = dist
            self.copies = n
            return self.value(ctx)
        v = hybrid_value(self.br, self.cfg[cluster], tok)
        self.window.append(v)
        return v
