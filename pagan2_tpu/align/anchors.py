"""Anchor discovery and DP tunnel (band) construction.

Replacements for the reference's anchoring stack
(src/utils/find_anchors.cpp, src/utils/ncbi_blast.cpp):

* prefix anchors — exact transliteration of the suffix-sort shared-prefix
  search (find_anchors.cpp:35-127), used for parity runs
  (--use-prefix-anchors);
* k-mer anchors — the native fast path standing in for in-process BLAST:
  unique-k-mer seeding + greedy diagonal chaining, all numpy;
* eliminate_bad_hits — diagonal-distance filtering
  (find_anchors.cpp:497-545);
* define_tunnel_with_overlapping_hits — monotone per-row band bounds
  with offset widening and empty-block detection
  (find_anchors.cpp:633-861).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SubstringHit:
    start_site_1: int
    start_site_2: int
    length: int
    score: float = 0.0
    plus_strand_1: bool = True
    plus_strand_2: bool = True


@dataclass
class TunnelBlock:
    sx: int = 0
    sy: int = 0
    ex: int = 0
    ey: int = 0

    def size(self) -> int:
        return (self.ex - self.sx) * (self.ey - self.sy)


# ----------------------------------------------------------------------
def find_prefix_anchors(s1: str, s2: str, min_length: int = 30
                        ) -> list[SubstringHit]:
    """Shared-prefix anchors via suffix sorting (find_anchors.cpp:35-127):
    sort all suffixes of both strings together; adjacent suffixes from
    different strings with a shared prefix >= min_length become hits;
    keep greedily by length, dropping overlaps.

    The C++ runtime (pagan2_tpu/native) serves this when available —
    the Python path below materialises every suffix (O(n^2) memory) and
    only remains as the parity fallback for short inputs."""
    from .. import native
    res = native.prefix_anchors(s1, s2, min_length)
    if res is not None:
        o1, o2, ol = res
        return [SubstringHit(int(a), int(b), int(l), int(l))
                for a, b, l in zip(o1, o2, ol)]
    n1, n2 = len(s1), len(s2)
    suffixes = sorted(
        [(s1[i:], 0, i) for i in range(n1)] +
        [(s2[j:], 1, j) for j in range(n2)])
    hits: list[SubstringHit] = []
    for a, b in zip(suffixes, suffixes[1:]):
        if a[1] == b[1]:
            continue
        # shared prefix length
        x, y = a[0], b[0]
        m = min(len(x), len(y))
        k = 0
        while k < m and x[k] == y[k]:
            k += 1
        if k >= min_length:
            p1 = a[2] if a[1] == 0 else b[2]
            p2 = b[2] if a[1] == 0 else a[2]
            hits.append(SubstringHit(p1, p2, k, k))

    hits.sort(key=lambda h: -h.length)

    hit1 = np.zeros(n1, dtype=bool)
    hit2 = np.zeros(n2, dtype=bool)
    kept = []
    for h in hits:
        sl1 = slice(h.start_site_1, h.start_site_1 + h.length)
        sl2 = slice(h.start_site_2, h.start_site_2 + h.length)
        if hit1[sl1].any() or hit2[sl2].any():
            continue
        hit1[sl1] = True
        hit2[sl2] = True
        kept.append(h)
    return kept


def find_hmmer_style_anchors(s1: str, s2: str, k: int = 16
                             ) -> list[SubstringHit]:
    """Native stand-in for find_hmmer_anchors (find_anchors.cpp:129-223).

    The reference popen()s `hmmsearch --max pagan.hmm` (a hardcoded HMM
    file in the working directory), keeps only the single best-E-value
    domain per sequence and emits exactly TWO 5-length anchors at the
    region's boundaries. Natively, the best (longest) k-mer chain hit
    plays the role of that best domain: one 5-length anchor at its
    start, one at its end — same two-pin tunnel shape, no subprocess."""
    hits = find_kmer_anchors(s1, s2, k=k)
    if not hits:
        return []
    best = max(hits, key=lambda h: h.length)
    pin = min(5, best.length)
    out = [SubstringHit(best.start_site_1, best.start_site_2, pin, pin)]
    e1 = best.start_site_1 + best.length - pin
    e2 = best.start_site_2 + best.length - pin
    if e1 > best.start_site_1 and e2 > best.start_site_2:
        out.append(SubstringHit(e1, e2, pin, pin))
    return out


def find_kmer_anchors(s1: str, s2: str, k: int = 16,
                      min_run: int = 1) -> list[SubstringHit]:
    """Native BLAST-stand-in: match k-mers that occur exactly once in
    each sequence, merge co-diagonal consecutive seeds into maximal runs.
    O(n) with dict seeding; robust for the closely-related sequences
    anchoring targets. Served by the C++ runtime when available."""
    from .. import native
    res = native.kmer_anchors(s1, s2, k, min_run)
    if res is not None:
        o1, o2, ol = res
        return [SubstringHit(int(a), int(b), int(l), int(l))
                for a, b, l in zip(o1, o2, ol)]

    def unique_kmers(s):
        pos = {}
        dup = set()
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if w in dup:
                continue
            if w in pos:
                del pos[w]
                dup.add(w)
            else:
                pos[w] = i
        return pos

    p1 = unique_kmers(s1)
    p2 = unique_kmers(s2)
    seeds = sorted((p1[w], p2[w]) for w in p1.keys() & p2.keys())

    hits = []
    cur = None
    for (i, j) in seeds:
        if cur and i - cur[0] == j - cur[1] and i <= cur[0] + cur[2]:
            cur[2] = i + k - cur[0]
        else:
            if cur:
                hits.append(cur)
            cur = [i, j, k]
    if cur:
        hits.append(cur)
    out = [SubstringHit(i, j, l, l) for (i, j, l) in hits
           if l >= min_run * k]
    return out


# ----------------------------------------------------------------------
def _distance(h: SubstringHit, s: SubstringHit) -> int:
    return abs((s.start_site_1 - s.start_site_2) -
               (h.start_site_1 - h.start_site_2))


def _probably_bad(h, s) -> bool:
    if h.start_site_1 < s.start_site_1 and h.start_site_2 > s.start_site_2 \
            and h.start_site_1 + h.length < s.start_site_1 + s.length:
        return True
    if h.start_site_1 > s.start_site_1 and h.start_site_2 < s.start_site_2 \
            and h.start_site_2 + h.length < s.start_site_2 + s.length:
        return True
    return False


def _totally_overlapping(h, s) -> bool:
    if h.start_site_1 >= s.start_site_1 and \
            h.start_site_1 + h.length <= s.start_site_1 + s.length:
        return True
    if h.start_site_2 >= s.start_site_2 and \
            h.start_site_2 + h.length <= s.start_site_2 + s.length:
        return True
    return False


def _overlaps_at_begin(h, s) -> int:
    overlap = 0
    if h.start_site_1 >= s.start_site_1 and \
            h.start_site_1 + h.length > s.start_site_1 + s.length:
        overlap = max(overlap, s.start_site_1 + s.length - h.start_site_1)
    if h.start_site_2 >= s.start_site_2 and \
            h.start_site_2 + h.length > s.start_site_2 + s.length:
        overlap = max(overlap, s.start_site_2 + s.length - h.start_site_2)
    return max(0, overlap)


def _partly_overlapping(h, s) -> bool:
    return _overlaps_at_begin(h, s) > 0 or _overlaps_at_begin(s, h) > 0


def eliminate_bad_hits(hits: list[SubstringHit],
                       threshold_totally_overlapping: int = 50,
                       threshold_partly_overlapping: int = 400
                       ) -> list[SubstringHit]:
    """find_anchors.cpp:497-545 (mutating scan with a good-hit set).

    The scan order is semantic (the good set grows as hits pass), but
    each hit's verdict is order-free over the current good set, so the
    inner loop vectorizes: `bad` is any-of and `decent` only matters
    when no good hit made it bad (the reference breaks out on bad
    without side effects). The scalar helpers above stay as the
    documentation/spec of these expressions."""
    n = len(hits)
    out: list[SubstringHit] = []
    if n == 0:
        return out
    gs1 = np.empty(n, np.int64)
    gs2 = np.empty(n, np.int64)
    gl = np.empty(n, np.int64)
    ng = 0
    T1 = threshold_totally_overlapping
    T2 = threshold_partly_overlapping
    for h in hits:
        bad = decent = False
        if ng:
            s1 = gs1[:ng]
            s2 = gs2[:ng]
            sl = gl[:ng]
            h1, h2, hl = h.start_site_1, h.start_site_2, h.length
            pb = ((h1 < s1) & (h2 > s2) & (h1 + hl < s1 + sl)) | \
                 ((h1 > s1) & (h2 < s2) & (h2 + hl < s2 + sl))
            to = ((h1 >= s1) & (h1 + hl <= s1 + sl)) | \
                 ((h2 >= s2) & (h2 + hl <= s2 + sl))
            o1 = np.where((h1 >= s1) & (h1 + hl > s1 + sl),
                          s1 + sl - h1, 0)
            o2 = np.where((h2 >= s2) & (h2 + hl > s2 + sl),
                          s2 + sl - h2, 0)
            o3 = np.where((s1 >= h1) & (s1 + sl > h1 + hl),
                          h1 + hl - s1, 0)
            o4 = np.where((s2 >= h2) & (s2 + sl > h2 + hl),
                          h2 + hl - s2, 0)
            partly = (np.maximum(o1, o2) > 0) | (np.maximum(o3, o4) > 0)
            dist = np.abs((s1 - s2) - (h1 - h2))
            pbto = pb | to
            bad = bool(np.any((pbto & (dist > T1)) |
                              (~pbto & partly & (dist > T2))))
            if not bad:
                decent = bool(np.any(pbto & (dist <= T1)))
        if not bad:
            if not decent:
                gs1[ng] = h.start_site_1
                gs2[ng] = h.start_site_2
                gl[ng] = h.length
                ng += 1
            out.append(h)
    return out


# ----------------------------------------------------------------------
def define_tunnel(hits: list[SubstringHit], s1_gapped: str, s2_gapped: str,
                  width: int = 15):
    """define_tunnel_with_overlapping_hits (find_anchors.cpp:633-861).

    Returns (upper, lower, empty_blocks): per-row [0..l1] inclusive j
    bounds in gapped coordinates (upper = min j, lower = max j — the
    reference's naming), plus empty blocks for --force-gap.
    """
    hits = [h for h in hits if h.plus_strand_1 and h.plus_strand_2]
    l1 = len(s1_gapped)
    l2 = len(s2_gapped)

    # ungapped position -> gapped position + 1
    i1 = [i + 1 for i, c in enumerate(s1_gapped) if c != "-"]
    i2 = [i + 1 for i, c in enumerate(s2_gapped) if c != "-"]

    min_h = 0
    max_h = l2
    lowest = np.full(l1 + 1, max_h + 1, dtype=np.int64)
    highest = np.full(l1 + 1, min_h - 1, dtype=np.int64)

    if hits:
        i1a = np.asarray(i1, np.int64)
        i2a = np.asarray(i2, np.int64)
        h1 = np.array([h.start_site_1 for h in hits], np.int64)
        h2 = np.array([h.start_site_2 for h in hits], np.int64)
        hl = np.array([h.length for h in hits], np.int64)
        reps = np.repeat(np.arange(len(hits)), hl)
        offs = np.arange(int(hl.sum()), dtype=np.int64) - \
            np.repeat(np.cumsum(hl) - hl, hl)
        xs = i1a[h1[reps] + offs]
        ys = i2a[h2[reps] + offs]
        np.minimum.at(lowest, xs, np.maximum(ys, min_h))
        np.maximum.at(highest, xs, np.minimum(ys, max_h))

    # monotone smoothing ("must not go zigzag") — running extremum
    # over the anchored entries only (vectorized: the old per-row
    # Python loops cost seconds per megabase tunnel, the dominant
    # band_smooth_s component)
    mh = highest > min_h
    if mh.any():
        highest[mh] = np.maximum.accumulate(highest[mh])
    ml = lowest < max_h
    if ml.any():
        lowest[ml] = np.minimum.accumulate(lowest[ml][::-1])[::-1]

    # empty blocks (for --force-gap): the per-row state machine only
    # acts at anchored/empty transitions — iterate those indices only
    empty_blocks: list[TunnelBlock] = []
    anch = highest >= min_h
    starts = set((np.where(anch[:-1] & ~anch[1:])[0] + 1).tolist())
    ends = set((np.where(anch[1:] & ~anch[:-1])[0] + 1).tolist())
    events = sorted(starts | ends | ({l1} if not anch[l1] else set()))
    cur = TunnelBlock(0, 0, 0, 0)
    for i in events:
        if i in starts:
            cur = TunnelBlock(i, int(highest[i - 1]), 0, 0)
        elif i in ends:
            if lowest[i] > cur.sy:
                cur.ex = i
                cur.ey = int(lowest[i])
                if cur.size() > 10:
                    empty_blocks.append(cur)
        elif i == l1 and not anch[i]:
            if max_h > cur.sy:
                cur.ex = i
                cur.ey = max_h
                if cur.size() > 10:
                    empty_blocks.append(cur)
    empty_blocks.sort(key=lambda b: -b.size())

    # fill gaps (vectorized forward/backward fill)
    valid = lowest < max_h
    idx = np.maximum.accumulate(
        np.where(valid, np.arange(l1 + 1), -1))
    lowest = np.where(idx >= 0, lowest[np.clip(idx, 0, None)], min_h)
    valid = highest > min_h
    ridx = np.minimum.accumulate(
        np.where(valid, np.arange(l1 + 1), l1 + 1)[::-1])[::-1]
    highest = np.where(ridx <= l1, highest[np.clip(ridx, None, l1)],
                       max_h)

    lowest[0] = min_h
    highest[l1] = max_h

    # widen on y
    highest = np.minimum(max_h, highest + width)
    lowest = np.maximum(min_h, lowest - width)

    # widen on x (ensure thickness against steps): detection
    # vectorized (overflow points ~ anchor count, not l1); the
    # width-bounded widening loops below are unchanged
    rise = np.where(highest[:-1] < highest[1:] - 1)[0] + 1
    overflow_high = [
        (int(i), bool(i == l1 or highest[i] == highest[i + 1]))
        for i in rise]
    for (i, gapped) in overflow_high:
        if gapped:
            x = i - 1
            while x >= max(i - width, 0) and highest[x] >= min_h:
                highest[x] = max(highest[x], highest[i])
                x -= 1
        else:
            x = i - 1
            while x >= max(i - width, 0) and highest[x] >= min_h:
                highest[x] = max(highest[x], highest[x + 1] - 1)
                x -= 1

    drop = np.where(lowest[1:] > lowest[:-1] + 1)[0][::-1]
    overflow_low = [
        (int(i), bool(i == 0 or lowest[i] == lowest[i - 1]))
        for i in drop]
    for (i, gapped) in overflow_low:
        if gapped:
            x = i + 1
            while x <= min(i + width, l1) and lowest[x] <= max_h:
                lowest[x] = min(lowest[x], lowest[i])
                x += 1
        else:
            x = i + 1
            while x <= min(i + width, l1) and lowest[x] <= max_h:
                lowest[x] = min(lowest[x], lowest[x - 1] + 1)
                x += 1

    upper = lowest.astype(np.int32)    # min j per row (reference naming)
    lower = highest.astype(np.int32)   # max j per row
    return upper, lower, empty_blocks


def tunnel_coverage(upper, lower, l1: int, l2: int) -> float:
    """In-band fraction of the DP matrix (viterbi_alignment.cpp:172-179)."""
    sums = int(np.sum(lower[:l1] - upper[:l1]))
    return float(sums) / (float(l1) * float(l2)) if l1 and l2 else 1.0


def replace_largest_block_with_gap(upper, lower, empty_blocks,
                                   threshold: int = 40000):
    """--force-gap: squeeze the band to a forced x-gap across the largest
    anchor-free block (viterbi_alignment.cpp:467-553 in spirit: the band
    collapses to the block's corner row so the block's cells vanish)."""
    if not empty_blocks:
        return None
    blk = empty_blocks[0]
    if blk.size() < threshold:
        return None
    empty_blocks.pop(0)
    upper = np.asarray(upper, np.int64).copy()
    lower = np.asarray(lower, np.int64).copy()
    for x in range(blk.sx, blk.ex + 1):
        upper[x] = max(upper[x], blk.sy)
        lower[x] = min(lower[x], max(blk.sy + 1, upper[x]))
    # restore the monotone-diagonal invariant the windowed kernels'
    # searchsorted schedule requires (A = i + upper and B = i + lower
    # non-decreasing; band_windows docstring): the squeeze drops
    # `lower` by the block width at the block's entry row and `upper`
    # at its exit, which de-sorts A/B and silently masked genuinely
    # in-band cells to -inf (dead-ending the banded fill into the full
    # O(L*R) fallback --force-gap exists to prevent).  Repair by
    # NARROWING: alignment paths are monotone in j, so once the band
    # is pinched to the corridor [sy, sy+1], entry-row cells RIGHT of
    # the corridor's diagonals (j > min later B) and exit-row cells
    # LEFT of them (j < max earlier A) can never lie on a path that
    # threads the corridor — trimming them is exact for linear chains
    # (and consistent with the forced-gap approximation for graph
    # pairs, whose small skip offsets could in principle hop a
    # trimmed row).  Narrowing also only SHRINKS the memory the
    # squeeze was invoked to save.
    i = np.arange(len(upper), dtype=np.int64)
    B = np.minimum.accumulate((lower + i)[::-1])[::-1]
    A = np.maximum.accumulate(upper + i)
    lower = B - i
    upper = np.minimum(A - i, lower)
    return upper, lower


# ----------------------------------------------------------------------
def graph_strings(g, with_gaps: bool):
    """Sequence::get_sequence_string (sequence.cpp): terminal graphs give
    their symbols; ancestors render skipped/non-real as '-' (gapped) or
    omit them (ungapped). Codon graphs translate each triplet site to
    ONE amino-acid char so hit/bound coordinates stay per-site — the
    reference anchors codon data on its protein translation
    (viterbi_alignment.cpp:54-60)."""
    from ..graph.sequence_graph import XSKIPPED, YSKIPPED, NON_REAL
    from ..models import alphabets as alph
    n = g.num_sites()
    if g.data_type == alph.CODON:
        from ..io.translate import codon_to_amino
        out = []
        for j in range(1, n - 1):
            skip = (g.path_state[j] in (XSKIPPED, YSKIPPED) or
                    g.site_type[j] == NON_REAL)
            if skip:
                if with_gaps:
                    out.append("-")
                continue
            sym = g.symbols[j]
            aa = codon_to_amino(sym) if len(sym) == 3 else "X"
            out.append(aa if aa not in ("", "-") else "X")
        return "".join(out)
    if g.terminal_sequence and not any(
            g.path_state[j] in (XSKIPPED, YSKIPPED) or
            g.site_type[j] == NON_REAL for j in range(1, n - 1)):
        return "".join(g.symbols[1:n - 1])
    syms = alph.ancestral_symbols(g.data_type)
    out = []
    gap = g.gap_symbol
    for j in range(1, n - 1):
        skip = (g.path_state[j] in (XSKIPPED, YSKIPPED) or
                g.site_type[j] == NON_REAL)
        if not skip:
            st = g.states[j]
            out.append(syms[st] if 0 <= st < len(syms) else "N")
        elif with_gaps:
            out.append(gap)
    return "".join(out)


def define_tunnel_for_graphs(left, right, *, use_prefix_anchors=False,
                             use_hmmer_anchors=False,
                             prefix_hit_length: int = 30,
                             kmer: int = 16, width: int = 15,
                             threshold_total: int = 50,
                             threshold_partly: int = 400):
    """Full anchoring pipeline for two sequence graphs: hit discovery on
    ungapped strings, bound construction on gapped coordinates
    (viterbi_alignment.cpp:44-185; anchor-mode dispatch :64-83)."""
    import time as _time
    t0 = _time.perf_counter()
    u1 = graph_strings(left, False)
    u2 = graph_strings(right, False)
    if use_hmmer_anchors:
        hits = find_hmmer_style_anchors(u1, u2, k=kmer)
    elif use_prefix_anchors:
        hits = find_prefix_anchors(u1, u2, prefix_hit_length)
    else:
        hits = find_kmer_anchors(u1, u2, k=kmer)
        hits = eliminate_bad_hits(hits, threshold_total, threshold_partly)
    t1 = _time.perf_counter()
    g1 = graph_strings(left, True)
    g2 = graph_strings(right, True)
    upper, lower, blocks = define_tunnel(hits, g1, g2, width)
    cov = tunnel_coverage(upper, lower, len(g1), len(g2))
    t2 = _time.perf_counter()
    PREP_TIMINGS["anchor_scan_s"] = t1 - t0
    PREP_TIMINGS["band_smooth_s"] = t2 - t1
    if R_PLOT_PREFIX is not None:
        from ..io.plots import write_anchors_for_R
        global _R_PLOT_COUNT
        _R_PLOT_COUNT += 1
        write_anchors_for_R(hits, upper, lower,
                            "%s_%d.r" % (R_PLOT_PREFIX, _R_PLOT_COUNT))
    return upper, lower, blocks, cov


# --plot-anchors-for-R (find_anchors.cpp:870-928): when set, every
# tunnel definition also dumps its hits+bounds as <prefix>_<n>.r
R_PLOT_PREFIX: str | None = None
_R_PLOT_COUNT = 0

# wall-seconds of the LAST define_tunnel_for_graphs call, split into
# hit discovery (anchor_scan_s) and bound construction/smoothing
# (band_smooth_s) — the megabase bench reports these so the dominant
# host-prep cost is tracked per round (VERDICT r4 item 8)
PREP_TIMINGS: dict = {}


def set_r_plot_prefix(prefix: str | None):
    global R_PLOT_PREFIX, _R_PLOT_COUNT
    R_PLOT_PREFIX = prefix
    _R_PLOT_COUNT = 0
