"""Sheared wavefront DP for graphs with bounded fan-in (the general case).

The reference's defining feature is that *graphs*, not strings, are
aligned: a site can have several bwd edges skipping other sites
(454/homopolymer error edges, ancestors bridging indels), and the hot
cell kernel iterates edge pairs (viterbi_alignment.cpp:1353-1436). The
linear sheared fills only need two previous anti-diagonals; a
bwd edge with offset o = i - prev(i) instead reads diagonal d-o (gap
moves) or d-ol-or (match moves). This kernel carries a ring of the last
G diagonals of M/X/Y in the scan state and gathers edge sources from it
by per-lane offset, so any pair whose offsets satisfy
max(ol) + max(or) <= G runs on device — banded (windowed, O(D x W)
memory like viterbi_banded) and batch-native (jobs stacked on the
leading axis for one launch per generation bucket).

Candidate evaluation order is the reference's exactly (gap: per-edge
ext, double, open, edges in bwd-list order, viterbi_alignment.cpp:
1328-1349; match: left-edge outer, right-edge inner, moves m, x, y,
:1353-1436) with strict-greater first-wins updates, so tracebacks are
identical to the host oracle.

Memory: one packed uint32 backpointer per in-band cell (bm 16 bits,
bx/by 8 bits each — wide enough that even beyond-cap graphs, K up to
147, never overflow a field) + O(G x W) ring state; match scores come
from a per-row gather of the left log-score table (no O(L*R) table
anywhere).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..graph.sequence_graph import SequenceGraph
from ..models.evol_model import EvolModel
from .settings import AlignSettings, X_MAT, Y_MAT, M_MAT
from .oracle import MatrixPtr, PathPtr
from .viterbi_sheared import _bucket

NEG = -np.inf
_BM_NONE = 65535   # packed uint32 layout: bm | bx<<16 | by<<24
_BX_NONE = 255
_BY_NONE = 255

# device-eligibility caps: per-site fan-in and total offset reach
# (KL*KR*3 candidate updates per diagonal; 8x8 = 192 is the practical
# compile-size ceiling. Graphs beyond the caps take the generic gather
# kernel.)
K_CAP = 8
G_CAP = 64


# anchoring gate for wide fan-in pairs (the global anchor_min_sites=3000
# assumes cheap linear cells); matches PileupConfig.anchor_reads_min_sites
SCAN_ANCHOR_MIN_SITES = 200

# graph-shape caps of the anchoring decision: pairs beyond any of them
# anchor from SCAN_ANCHOR_MIN_SITES sites
ANCHOR_OFF_CAP = 7       # per-side max bwd-edge offset
ANCHOR_K_CAP_R = 4       # right-side max fan-in
ANCHOR_CODE_CAP = 255    # candidate codes KL*KR*3, KL*3 and KR*3 stay below


def scan_core_bound(KL: int, OL: int, KR: int, OR: int) -> bool:
    """True when a fan-in pair is wide enough (long edge offsets, deep
    right fan-in, many candidates per cell) to anchor from
    SCAN_ANCHOR_MIN_SITES instead of anchor_min_sites — the reference
    anchors EVERY pair (node.cpp:87-152).

    A function of the graph shapes alone, so the same input produces
    the same alignment on every platform and batch width (the
    multihost test asserts byte-identical cross-process output)."""
    return (OL > ANCHOR_OFF_CAP or OR > ANCHOR_OFF_CAP
            or KR > ANCHOR_K_CAP_R or KL * KR * 3 >= ANCHOR_CODE_CAP
            or KL * 3 >= ANCHOR_CODE_CAP or KR * 3 >= ANCHOR_CODE_CAP)


def fanin_overcap(KL: int, KR: int, OL: int, OR: int) -> bool:
    """True when a fan-in fill is beyond the one-hot cores and the GPU
    kernel (fan-in above K_CAP, or bucketed offsets whose product
    exceeds 64): it takes the generic gather scan core."""
    return (KL > K_CAP or KR > K_CAP
            or _k_bucket(OL) * _k_bucket(OR) > 64)


def effective_anchor_gate(left, right, gate: int) -> int:
    """Per-pair anchoring size gate: `gate` (anchor_min_sites), lowered
    to SCAN_ANCHOR_MIN_SITES when this fan-in pair is statically bound
    to the scan core.  The fanin_stats walks are pure Python, so they
    only run when the lowered gate could actually change the decision
    (SCAN_ANCHOR_MIN_SITES < min(sites) <= gate)."""
    n = min(left.num_sites(), right.num_sites())
    if not (SCAN_ANCHOR_MIN_SITES < n <= gate):
        return gate
    KL, OL = fanin_stats(left)
    KR, OR = fanin_stats(right)
    if scan_core_bound(KL, OL, KR, OR):
        return SCAN_ANCHOR_MIN_SITES
    return gate


def fanin_stats(g: SequenceGraph):
    """(max fan-in K, max bwd-edge offset) over sites 1..N-1 — the
    device-eligibility numbers for this graph."""
    K = 1
    O = 1
    starts = g.edges.start
    for i in range(1, g.num_sites()):
        b = g.bwd[i]
        if len(b) > K:
            K = len(b)
        for e in b:
            o = i - starts[e]
            if o > O:
                O = o
    return K, O


def _g_bucket(n: int) -> int:
    g = 2
    while g < n:
        g *= 2
    return g


def _k_bucket(n: int) -> int:
    """Candidate-count bucket. K is a static shape in every scan-core
    compile key, and raw K creeps up one edge at a time as a pileup
    root accumulates fan-in — each step would recompile every core.
    Padded candidate slots are invalid by construction (offset 0 is
    masked in prepare_fanin/stack_fanin), so rounding K up costs only
    the extra candidate lanes."""
    if n <= 4:
        return n
    for b in (6, 8, 12, 16, 24, 32):
        if n <= b:
            return b
    return _bucket(n)


# ----------------------------------------------------------------------
def _build_core_onehot(KL: int, KR: int, OLm: int, ORm: int, G: int,
                       W: int):
    """Fill core with one-hot offset selection instead of gathers.

    Gathers make the core's compile time grow quickly with shape;
    edge offsets are small integers (<= OLm/ORm), so each
    per-candidate gather is replaced by a mask-select over ring planes
    aligned with ONE dynamic slice per (matrix, depth) and then
    STATICALLY lane-shifted — compare + select ops only, which both
    compiles fast and vectorizes cleanly. Candidate evaluation order is
    unchanged (strict first-wins parity with the oracle)."""

    def core(TL, loff, llw, lopen, gexti_ext, upper_ext, lower_ext,
             rs_rext, gjx_rext, roff_rext, rlw_rext, ropen_rext,
             ilo_ext, lng, lgo, Ldp, Rdp):
        B = TL.shape[0]
        nf = TL.shape[2]
        f = TL.dtype
        neg = jnp.array(NEG, f)
        Ext = gjx_rext.shape[1]
        RextOff = Ext - W - 1
        Gm = min(G, OLm + ORm)      # deepest ring plane actually read

        tt = jnp.arange(W)[None, :]                  # (1, W)
        lngb = lng[:, None]
        lgob = lgo[:, None]
        Ldpb = Ldp[:, None]
        Rdpb = Rdp[:, None]
        cornerd = Ldpb + Rdpb - 2

        ring0 = jnp.full((B, G, W), neg, f)
        negpad = jnp.full((B, W), neg, f)

        def win_rows(vec_ext, ilo):
            return lax.dynamic_slice_in_dim(vec_ext, ilo, W, axis=1)

        def win_rows3(arr_ext, ilo):                 # (B, Lpad, K)
            return lax.dynamic_slice_in_dim(arr_ext, ilo, W, axis=1)

        def rev_cols(vec_rext, start):
            return lax.dynamic_slice_in_dim(vec_rext, start, W, axis=1)

        def rev_cols3(arr_rext, start):              # (B, K, Ext)
            return lax.dynamic_slice_in_dim(arr_rext, start, W, axis=2)

        # aligned ring views span local lanes [-PAD, W) so a static
        # shift by s <= PAD can reach sources at t - s + delta < 0 in
        # the current frame (valid reads into the previous window's
        # frame, which the gather core permits)
        PAD = max(OLm, 1)

        def sh(v, s):
            """Static lane shift of an aligned (PAD + W)-wide view:
            out[t] = plane[t - s + delta]."""
            return v[:, PAD - s: PAD - s + W]

        def step(carry, d):
            rM, rX, rY, sM, sX, sY = carry

            iwin = lax.dynamic_slice(ilo_ext, (d,), (G + 1,))
            ilo = iwin[G]

            iig = ilo + tt                           # (1, W) global row
            jj = d - iig
            start = RextOff - (d - ilo)

            up = win_rows(upper_ext, ilo)
            lo = win_rows(lower_ext, ilo)
            valid = (jj >= 0) & (jj < Rdpb) & (iig < Ldpb) & \
                (jj >= up) & (jj <= lo)

            gexti = win_rows(gexti_ext, ilo)
            gjx = rev_cols(gjx_rext, start)
            rs = rev_cols(rs_rext, start)
            roff = rev_cols3(roff_rext, start)       # (B, KR, W)
            rlw = rev_cols3(rlw_rext, start)
            ropen = rev_cols3(ropen_rext, start)
            loffw = win_rows3(loff, ilo)             # (B, W, KL)
            llww = win_rows3(llw, ilo)
            lopenw = win_rows3(lopen, ilo)

            TLw = win_rows3(TL, ilo)                 # (B, W, nf)
            ms = jnp.take_along_axis(
                TLw, jnp.clip(rs, 0, nf - 1)[:, :, None], axis=2)[:, :, 0]

            # ring planes aligned to this diagonal's window (one
            # dynamic slice per matrix and depth; window starts are
            # monotone so delta >= 0, and out-of-window reads are NEG).
            # The slice is (PAD + W) wide: view[u] = plane[u - PAD +
            # delta], so sh(view, s)[t] = plane[t - s + delta] exactly
            # as the gather core indexes.
            lpad = jnp.full((B, PAD), neg, f)
            rpad = jnp.full((B, W + PAD), neg, f)

            def align(plane, g):
                delta = ilo - iwin[G - g]
                ext = jnp.concatenate([lpad, plane, rpad], axis=1)
                sl = lax.dynamic_slice_in_dim(ext, delta, PAD + W, axis=1)
                # delta beyond W+PAD clamps the slice start; no source
                # can be valid there, so blank the view
                return jnp.where(delta > W + PAD, neg, sl)

            AM = [None] + [align(rM[:, g - 1], g) for g in range(1, Gm + 1)]
            AX = [None] + [align(rX[:, g - 1], g) for g in range(1, Gm + 1)]
            AY = [None] + [align(rY[:, g - 1], g) for g in range(1, Gm + 1)]

            def upd(best, code, cand, c):
                take = cand > best
                return (jnp.where(take, cand, best),
                        jnp.where(take, c, code))

            # ---- X: gap consuming left site i (per edge: ext, double,
            # open; viterbi_alignment.cpp:1328-1349). Source lane shift
            # equals the offset, so the one-hot term g uses sh(A_g, g).
            bestX = jnp.full((B, W), neg, f)
            codeX = jnp.full((B, W), _BX_NONE, jnp.int32)
            shx = [None] + [sh(AX[g], g) for g in range(1, min(OLm, Gm) + 1)]
            shy = [None] + [sh(AY[g], g) for g in range(1, min(OLm, Gm) + 1)]
            shm = [None] + [sh(AM[g], g) for g in range(1, min(OLm, Gm) + 1)]
            for k in range(KL):
                o = loffw[:, :, k]
                gx = gy = gm = negpad
                for g in range(1, min(OLm, Gm) + 1):
                    m = o == g
                    gx = jnp.where(m, shx[g], gx)
                    gy = jnp.where(m, shy[g], gy)
                    gm = jnp.where(m, shm[g], gm)
                bestX, codeX = upd(bestX, codeX, gx + gjx, k * 3)
                bestX, codeX = upd(bestX, codeX, gy + lgob, k * 3 + 1)
                bestX, codeX = upd(bestX, codeX,
                                   gm + lngb + lopenw[:, :, k], k * 3 + 2)

            # ---- Y: gap consuming right site j (no lane shift) ----
            bestY = jnp.full((B, W), neg, f)
            codeY = jnp.full((B, W), _BY_NONE, jnp.int32)
            ay0 = [None] + [sh(AY[g], 0) for g in range(1, min(ORm, Gm) + 1)]
            ax0 = [None] + [sh(AX[g], 0) for g in range(1, min(ORm, Gm) + 1)]
            am0 = [None] + [sh(AM[g], 0) for g in range(1, min(ORm, Gm) + 1)]
            for k in range(KR):
                o = roff[:, k, :]
                gy = gx = gm = negpad
                for g in range(1, min(ORm, Gm) + 1):
                    m = o == g
                    gy = jnp.where(m, ay0[g], gy)
                    gx = jnp.where(m, ax0[g], gx)
                    gm = jnp.where(m, am0[g], gm)
                bestY, codeY = upd(bestY, codeY, gy + gexti, k * 3)
                bestY, codeY = upd(bestY, codeY, gx + lgob, k * 3 + 1)
                bestY, codeY = upd(bestY, codeY,
                                   gm + lngb + ropen[:, k, :], k * 3 + 2)

            # ---- M: match consuming both (left edge outer, right edge
            # inner; per pair m, x, y; viterbi_alignment.cpp:1353-1436).
            # Total offset s+r selects plane s+r shifted by the left
            # offset s; the (s, r) masks factor per side.
            bestM = jnp.full((B, W), neg, f)
            codeM = jnp.full((B, W), _BM_NONE, jnp.int32)
            mbase = lngb + ms
            shM = {}
            shX2 = {}
            shY2 = {}
            for s in range(1, OLm + 1):
                for r in range(1, ORm + 1):
                    if s + r <= Gm and (s, s + r) not in shM:
                        shM[(s, s + r)] = sh(AM[s + r], s)
                        shX2[(s, s + r)] = sh(AX[s + r], s)
                        shY2[(s, s + r)] = sh(AY[s + r], s)
            for kl in range(KL):
                ol = loffw[:, :, kl]
                lw = llww[:, :, kl]
                lmask = [None] + [ol == s for s in range(1, OLm + 1)]
                for kr in range(KR):
                    orr = roff[:, kr, :]
                    gm = gx = gy = negpad
                    for s in range(1, OLm + 1):
                        for r in range(1, ORm + 1):
                            if s + r > Gm:
                                continue
                            mm = lmask[s] & (orr == r)
                            gm = jnp.where(mm, shM[(s, s + r)], gm)
                            gx = jnp.where(mm, shX2[(s, s + r)], gx)
                            gy = jnp.where(mm, shY2[(s, s + r)], gy)
                    base = mbase + lw + rlw[:, kr, :]
                    c0 = (kl * KR + kr) * 3
                    bestM, codeM = upd(bestM, codeM, gm + lngb + base, c0)
                    bestM, codeM = upd(bestM, codeM, gx + base, c0 + 1)
                    bestM, codeM = upd(bestM, codeM, gy + base, c0 + 2)

            okx = valid & (iig > 0) & jnp.isfinite(bestX)
            oky = valid & (jj > 0) & jnp.isfinite(bestY)
            okm = valid & (iig > 0) & (jj > 0) & jnp.isfinite(bestM)
            X = jnp.where(okx, bestX, neg)
            Y = jnp.where(oky, bestY, neg)
            M = jnp.where(okm, bestM, neg)

            # seed cell (0, 0) on diagonal 0
            seed = (iig == 0) & (jj == 0)
            M = jnp.where(seed, jnp.zeros((), f), M)

            bp = (jnp.where(okm, codeM, _BM_NONE) +
                  (jnp.where(okx, codeX, _BX_NONE) << 16) +
                  (jnp.where(oky, codeY, _BY_NONE) << 24)
                  ).astype(jnp.uint32)

            # roll the ring: new diagonal becomes plane 0
            rM = jnp.concatenate([M[:, None], rM[:, :-1]], axis=1)
            rX = jnp.concatenate([X[:, None], rX[:, :-1]], axis=1)
            rY = jnp.concatenate([Y[:, None], rY[:, :-1]], axis=1)

            # per-job snapshot of the ring at the job's corner diagonal
            hit = (d == cornerd)[:, :, None].swapaxes(1, 2)  # (B, 1, 1)
            sM = jnp.where(hit, rM, sM)
            sX = jnp.where(hit, rX, sX)
            sY = jnp.where(hit, rY, sY)

            return (rM, rX, rY, sM, sX, sY), bp

        Dscan = ilo_ext.shape[0] - G
        carry, bps = lax.scan(
            step, (ring0, ring0, ring0, ring0, ring0, ring0),
            jnp.arange(Dscan))
        _, _, _, sM, sX, sY = carry
        return bps, sM, sX, sY

    return core


def _build_core(KL: int, KR: int, G: int, W: int):
    """Generic gather fill core for arbitrary fan-in/offsets (beyond
    the one-hot caps: deep homopolymer runs, heavily merged sampled
    graphs). All candidates are stacked in the reference's evaluation
    order and reduced with max + argmax — argmax returns the FIRST
    occurrence of the maximum, which is exactly the strict-greater
    first-wins rule — so a handful of large gathers replaces a
    per-candidate gather chain (whose HLO count grows with K x K and
    makes compiles slow)."""

    def core(TL, loff, llw, lopen, gexti_ext, upper_ext, lower_ext,
             rs_rext, gjx_rext, roff_rext, rlw_rext, ropen_rext,
             ilo_ext, lng, lgo, Ldp, Rdp):
        B = TL.shape[0]
        nf = TL.shape[2]
        f = TL.dtype
        neg = jnp.array(NEG, f)
        Ext = gjx_rext.shape[1]
        RextOff = Ext - W - 1

        tt = jnp.arange(W)[None, :]                  # (1, W)
        Ldpb = Ldp[:, None]
        Rdpb = Rdp[:, None]
        cornerd = Ldpb + Rdpb - 2
        lng3 = lng[:, None, None]
        lgo3 = lgo[:, None, None]
        lng4 = lng[:, None, None, None]

        ring0 = jnp.full((B, G * W), neg, f)
        snap0 = jnp.full((B, G, W), neg, f)

        def win_rows(vec_ext, ilo):
            return lax.dynamic_slice_in_dim(vec_ext, ilo, W, axis=1)

        def win_rows3(arr_ext, ilo):                 # (B, Lpad, K)
            return lax.dynamic_slice_in_dim(arr_ext, ilo, W, axis=1)

        def rev_cols(vec_rext, start):
            return lax.dynamic_slice_in_dim(vec_rext, start, W, axis=1)

        def rev_cols3(arr_rext, start):              # (B, K, Ext)
            return lax.dynamic_slice_in_dim(arr_rext, start, W, axis=2)

        def step(carry, d):
            rM, rX, rY, sM, sX, sY = carry

            # window schedule: ilo of this diagonal and the G before it
            iwin = lax.dynamic_slice(ilo_ext, (d,), (G + 1,))
            ilo = iwin[G]
            # ofs[o] = flat ring offset for source diagonal d-o:
            # (o-1)*W + (ilo[d] - ilo[d-o]); ofs[0] unused
            ofs = (jnp.arange(G + 1) - 1) * W + (ilo - iwin[::-1])

            iig = ilo + tt                           # (1, W) global row
            jj = d - iig
            start = RextOff - (d - ilo)

            up = win_rows(upper_ext, ilo)
            lo = win_rows(lower_ext, ilo)
            valid = (jj >= 0) & (jj < Rdpb) & (iig < Ldpb) & \
                (jj >= up) & (jj <= lo)

            gexti = win_rows(gexti_ext, ilo)
            gjx = rev_cols(gjx_rext, start)
            rs = rev_cols(rs_rext, start)
            roff = rev_cols3(roff_rext, start)       # (B, KR, W)
            rlw = rev_cols3(rlw_rext, start)
            ropen = rev_cols3(ropen_rext, start)
            loffw = win_rows3(loff, ilo)             # (B, W, KL)
            llww = win_rows3(llw, ilo)
            lopenw = win_rows3(lopen, ilo)

            TLw = win_rows3(TL, ilo)                 # (B, W, nf)
            ms = jnp.take_along_axis(
                TLw, jnp.clip(rs, 0, nf - 1)[:, :, None], axis=2)[:, :, 0]

            def srcidx(o, shift):
                """Flat ring index + validity for sources at ring
                diagonal d-o, global row iig - shift (broadcasts)."""
                s_ = tt - shift + jnp.take(ofs, jnp.clip(o, 0, G))
                rel = s_ - (jnp.clip(o, 1, G) - 1) * W
                ok = (o > 0) & (o <= G) & (rel >= 0) & (rel < W)
                return jnp.clip(s_, 0, G * W - 1), ok

            def pick(ring, idx):
                # explicit middle axes: right-aligned broadcasting
                # would otherwise collide the batch axis with a slot
                # axis once B > 1 (e.g. (B, GW) vs (B, KL, KR, W))
                shape = (ring.shape[0],) + (1,) * (idx.ndim - 2) \
                    + (G * W,)
                br = jnp.broadcast_to(ring.reshape(shape),
                                      idx.shape[:-1] + (G * W,))
                return jnp.take_along_axis(br, idx, axis=-1)

            # ---- X: gap consuming left site i; candidate order per
            # edge slot: ext, double, open (codes k*3+move;
            # viterbi_alignment.cpp:1328-1349) ----
            oX = jnp.moveaxis(loffw, 2, 1)           # (B, KL, W)
            idxX, okX = srcidx(oX, oX)
            candX = jnp.stack(
                [pick(rX, idxX) + gjx[:, None, :],
                 pick(rY, idxX) + lgo3,
                 pick(rM, idxX) + lng3 + jnp.moveaxis(lopenw, 2, 1)],
                axis=2)                              # (B, KL, 3, W)
            candX = jnp.where(okX[:, :, None, :], candX, neg)
            candX = candX.reshape(B, KL * 3, W)
            bestX = jnp.max(candX, axis=1)
            codeX = jnp.argmax(candX, axis=1).astype(jnp.int32)

            # ---- Y: gap consuming right site j ----
            idxY, okY = srcidx(roff, 0)
            candY = jnp.stack(
                [pick(rY, idxY) + gexti[:, None, :],
                 pick(rX, idxY) + lgo3,
                 pick(rM, idxY) + lng3 + ropen],
                axis=2)                              # (B, KR, 3, W)
            candY = jnp.where(okY[:, :, None, :], candY, neg)
            candY = candY.reshape(B, KR * 3, W)
            bestY = jnp.max(candY, axis=1)
            codeY = jnp.argmax(candY, axis=1).astype(jnp.int32)

            # ---- M: match consuming both; pair order row-major (left
            # edge outer), per pair m, x, y (codes (kl*KR+kr)*3+move;
            # viterbi_alignment.cpp:1353-1436) ----
            olM = jnp.moveaxis(loffw, 2, 1)[:, :, None, :]  # (B,KL,1,W)
            orM = roff[:, None, :, :]                       # (B,1,KR,W)
            oM = olM + orM
            idxM, okg = srcidx(oM, olM)
            okM = (olM > 0) & (orM > 0) & okg
            mbase = lng[:, None] + ms                       # (B, W)
            base = (mbase[:, None, None, :]
                    + jnp.moveaxis(llww, 2, 1)[:, :, None, :]
                    + rlw[:, None, :, :])
            candM = jnp.stack(
                [pick(rM, idxM) + lng4 + base,
                 pick(rX, idxM) + base,
                 pick(rY, idxM) + base],
                axis=3)                              # (B, KL, KR, 3, W)
            candM = jnp.where(okM[:, :, :, None, :], candM, neg)
            candM = candM.reshape(B, KL * KR * 3, W)
            bestM = jnp.max(candM, axis=1)
            codeM = jnp.argmax(candM, axis=1).astype(jnp.int32)

            okx = valid & (iig > 0) & jnp.isfinite(bestX)
            oky = valid & (jj > 0) & jnp.isfinite(bestY)
            okm = valid & (iig > 0) & (jj > 0) & jnp.isfinite(bestM)
            X = jnp.where(okx, bestX, neg)
            Y = jnp.where(oky, bestY, neg)
            M = jnp.where(okm, bestM, neg)

            # seed cell (0, 0) on diagonal 0
            seed = (iig == 0) & (jj == 0)
            M = jnp.where(seed, jnp.zeros((), f), M)

            bp = (jnp.where(okm, codeM, _BM_NONE) +
                  (jnp.where(okx, codeX, _BX_NONE) << 16) +
                  (jnp.where(oky, codeY, _BY_NONE) << 24)
                  ).astype(jnp.uint32)

            # roll the ring: new diagonal becomes index 0
            rM = jnp.concatenate([M, rM[:, :-W]], axis=1)
            rX = jnp.concatenate([X, rX[:, :-W]], axis=1)
            rY = jnp.concatenate([Y, rY[:, :-W]], axis=1)

            # per-job snapshot of the ring at the job's corner diagonal
            hit = (d == cornerd)[:, :, None].swapaxes(1, 2)  # (B, 1, 1)
            rs3 = lambda r: r.reshape(B, G, W)  # noqa: E731
            sM = jnp.where(hit, rs3(rM), sM)
            sX = jnp.where(hit, rs3(rX), sX)
            sY = jnp.where(hit, rs3(rY), sY)

            return (rM, rX, rY, sM, sX, sY), bp

        Dscan = ilo_ext.shape[0] - G
        carry, bps = lax.scan(
            step, (ring0, ring0, ring0, snap0, snap0, snap0),
            jnp.arange(Dscan))
        _, _, _, sM, sX, sY = carry
        return bps, sM, sX, sY

    return core


_core_cache: dict = {}

# distinct scan-core COMPILE keys this process: the static core key
# PLUS every argument shape/dtype (one jitted wrapper retraces per
# stacked batch/extent shape, so counting wrappers alone would
# undercount real XLA compiles).  This is the observable the K/G/offset
# bucketing exists to minimize; executor.kernel_key_counts reports it.
FILL_KEYS: set = set()


def get_fanin_fill(KL: int, KR: int, G: int, W: int,
                   OLm: int | None = None, ORm: int | None = None):
    """Jitted fill for the static shape key. When the max per-side
    offsets are known and small, the one-hot core is used (fast
    compiles); otherwise the gather core."""
    key = (KL, KR, G, W, OLm, ORm)
    if key not in _core_cache:
        if OLm is not None and ORm is not None and OLm * ORm <= 64:
            core = _build_core_onehot(KL, KR, OLm, ORm, G, W)
        else:
            core = _build_core(KL, KR, G, W)
        fn = jax.jit(core)

        def counted(*args, _fn=fn, _key=key):
            # .shape/.dtype/.sharding attrs only — np.asarray would
            # force a device->host transfer on sharded inputs.  The
            # device/sharding token matters: the same shapes filled on
            # the GPU, the host CPU device, and a jobs mesh are three
            # separate XLA compiles
            FILL_KEYS.add(_key + (str(getattr(
                args[0], "sharding", "np")),) + tuple(
                (tuple(getattr(a, "shape", ())),
                 str(getattr(a, "dtype", type(a).__name__)))
                for a in args))
            return _fn(*args)

        _core_cache[key] = counted
    return _core_cache[key]


# ----------------------------------------------------------------------
def prepare_fanin(left: SequenceGraph, right: SequenceGraph,
                  model: EvolModel, settings: AlignSettings,
                  dtype=np.float64):
    """Host-side per-job arrays (unpadded; stacking pads to buckets)."""
    L = left.num_sites() - 1
    R = right.num_sites() - 1
    la = left.padded_bwd_arrays()
    ra = right.padded_bwd_arrays()

    m = model
    gext = m.log_gap_ext()
    gend = gext if settings.no_terminal_edges else m.log_gap_end_ext()
    lgo = m.log_gap_open()

    pair_end = bool(settings.pair_end_reads)
    xr1 = settings.x_read1_length if pair_end else -2
    yr1 = settings.y_read1_length if pair_end else -2

    def side(arr, n, read1):
        prev = arr["prev"][:n]
        mask = arr["mask"][:n] & (prev >= 0) & \
            (prev < np.arange(n)[:, None])
        off = np.where(mask, np.arange(n)[:, None] - prev, 0
                       ).astype(np.int32)
        lw = np.where(mask, arr["logw"][:n], 0.0).astype(dtype)
        # open penalty at the predecessor site (basic_alignment.h:490-513)
        op = np.full(prev.shape, lgo, dtype)
        if settings.reduced_terminal_gap_penalties:
            op[prev == 0] = 0.0
            if pair_end and read1 >= 0:
                op[prev == read1] = 0.0
        op = np.where(mask, op, 0.0)
        return off, lw, op

    loff, llw, lopen = side(la, L, xr1)
    roff, rlw, ropen = side(ra, R, yr1)

    gext_i = np.full(L, gext, dtype)
    gext_i[0] = gend
    gext_i[L - 1] = gend
    gext_j = np.full(R, gext, dtype)
    gext_j[0] = gend
    gext_j[R - 1] = gend
    # pair-end break extension overrides the terminal rule at the read1
    # boundary (compute_fwd_scores gap-type priority, oracle.py:267-280)
    if pair_end:
        gbrk = dtype(m.log_gap_break_ext())
        if 0 <= xr1 < L:
            gext_i[xr1] = gbrk
        if 0 <= yr1 < R:
            gext_j[yr1] = gbrk

    lstates = np.asarray(left.states[:L], np.int32)
    rstates = np.asarray(right.states[:R], np.int32)

    KLg, OL = fanin_stats(left)
    KRg, OR = fanin_stats(right)
    return dict(
        L=L, R=R, KL=loff.shape[1], KR=roff.shape[1],
        OL=OL, OR=OR,
        loff=loff, llw=llw, lopen=lopen,
        roff=roff, rlw=rlw, ropen=ropen,
        gext_i=gext_i, gext_j=gext_j,
        lstates=lstates, rstates=rstates,
        leid=la["eid"][:L + 1], lprev=la["prev"][:L + 1],
        reid=ra["eid"][:R + 1], rprev=ra["prev"][:R + 1],
        lng=dtype(m.log_non_gap()), lgo=dtype(lgo),
        gext=dtype(gext), gend=dtype(gend),
        pair_end=pair_end and (xr1 >= 0 or yr1 >= 0),
        log_score=model.log_score.astype(dtype),
    )


def fanin_device_eligible(inp) -> bool:
    return (inp["KL"] <= K_CAP and inp["KR"] <= K_CAP and
            inp["OL"] + inp["OR"] <= G_CAP)


def stack_fanin(inputs: list[dict], Lp: int, Rp: int, KL: int, KR: int,
                G: int, W: int | None = None, ilo=None, dtype=np.float64):
    """Pad/stack per-job prepare_fanin dicts into core args. W/ilo:
    optional band window (single-job banded use); default full width."""
    B = len(inputs)
    nf = inputs[0]["log_score"].shape[0]
    D = Lp + Rp - 1
    if W is None:
        W = Lp
    if ilo is None:
        ilo = np.zeros(D, np.int32)
    Lpad = Lp + W + 1

    pad_front = max(0, (D - 1) - (Rp - 1))
    Ext = _bucket(pad_front + Rp + W + 1)
    RextOff = Ext - W - 1

    TL = np.zeros((B, Lpad, nf), dtype)
    loff = np.zeros((B, Lpad, KL), np.int32)
    llw = np.zeros((B, Lpad, KL), dtype)
    lopen = np.zeros((B, Lpad, KL), dtype)
    gexti = np.zeros((B, Lpad), dtype)
    upper = np.zeros((B, Lpad), np.int32)
    lower = np.full((B, Lpad), 0, np.int32)
    rs = np.full((B, Ext), nf, np.int32)
    gjx = np.zeros((B, Ext), dtype)
    roff = np.zeros((B, KR, Ext), np.int32)
    rlw = np.zeros((B, KR, Ext), dtype)
    ropen = np.zeros((B, KR, Ext), dtype)
    lng = np.zeros(B, dtype)
    lgo = np.zeros(B, dtype)
    Ldp = np.zeros(B, np.int32)
    Rdp = np.zeros(B, np.int32)

    for b, inp in enumerate(inputs):
        L, R = inp["L"], inp["R"]
        kl = inp["loff"].shape[1]
        kr = inp["roff"].shape[1]
        TL[b, :L] = inp["log_score"][inp["lstates"]]
        loff[b, :L, :kl] = inp["loff"]
        llw[b, :L, :kl] = inp["llw"]
        lopen[b, :L, :kl] = inp["lopen"]
        gexti[b, :L] = inp["gext_i"]
        lower[b, :L] = inp.get("band_lower", np.full(L, R - 1))[:L]
        upper[b, :L] = inp.get("band_upper", np.zeros(L))[:L]

        def rput(dst, vec):
            n = len(vec)
            dst[RextOff - n + 1: RextOff + 1] = vec[::-1]

        rput(rs[b], inp["rstates"])
        rput(gjx[b], inp["gext_j"])
        for k in range(kr):
            rput(roff[b, k], inp["roff"][:, k])
            rput(rlw[b, k], inp["rlw"][:, k])
            rput(ropen[b, k], inp["ropen"][:, k])
        lng[b] = inp["lng"]
        lgo[b] = inp["lgo"]
        Ldp[b] = L
        Rdp[b] = R

    ilo_ext = np.zeros(D + G, np.int32)
    ilo_ext[G:] = ilo[:D]
    return (jnp.asarray(TL), jnp.asarray(loff), jnp.asarray(llw),
            jnp.asarray(lopen), jnp.asarray(gexti), jnp.asarray(upper),
            jnp.asarray(lower), jnp.asarray(rs), jnp.asarray(gjx),
            jnp.asarray(roff), jnp.asarray(rlw), jnp.asarray(ropen),
            jnp.asarray(ilo_ext), jnp.asarray(lng), jnp.asarray(lgo),
            jnp.asarray(Ldp), jnp.asarray(Rdp))


# ----------------------------------------------------------------------
class _SnapScores:
    """Score plane view over a job's corner-ring snapshot: snap[g] holds
    diagonal (L+R-2) - g."""

    def __init__(self, snap, ilo, Dlast, W):
        self.snap = np.asarray(snap)
        self.ilo = ilo
        self.Dlast = Dlast   # diagonal held by snap[0]
        self.W = W
        self.G = self.snap.shape[0]

    def __getitem__(self, ij):
        i, j = ij
        g = self.Dlast - (i + j)
        if g < 0 or g >= self.G:
            return NEG
        t = i - int(self.ilo[i + j])
        if t < 0 or t >= self.W:
            return NEG
        return float(self.snap[g, t])


class _FaninCells:
    """Oracle-style cell accessor over the packed uint32 stripe."""

    def __init__(self, bp, ilo, inp, left, right, snaps=None,
                 kr_decode=None):
        self.bp = np.asarray(bp)
        self.ilo = ilo
        self.W = self.bp.shape[1]
        self.inp = inp
        self.left = left
        self.right = right
        # M codes were packed with the launch bucket's KR, which may
        # exceed this job's true fan-in
        self.KR = kr_decode or inp["KR"]
        if snaps is not None:
            Dlast = inp["L"] + inp["R"] - 2
            self.score = {w: _SnapScores(s, ilo, Dlast, self.W)
                          for w, s in zip((M_MAT, X_MAT, Y_MAT), snaps)}

    def _code(self, i, j):
        d = i + j
        t = i - int(self.ilo[d])
        if t < 0 or t >= self.W or d >= self.bp.shape[0]:
            return _BM_NONE + (_BX_NONE << 16) + (_BY_NONE << 24)
        return int(self.bp[d, t])

    def cell(self, which, i, j) -> MatrixPtr:
        code = self._code(i, j)
        inp = self.inp
        mp = MatrixPtr()
        if which == M_MAT:
            c = code & 65535
            if c == _BM_NONE:
                return mp
            pair, move = divmod(c, 3)
            kl, kr = divmod(pair, self.KR)
            mp.matrix = (M_MAT, X_MAT, Y_MAT)[move]
            mp.x_ind = int(inp["lprev"][i, kl])
            mp.y_ind = int(inp["rprev"][j, kr])
            mp.x_edge_ind = int(inp["leid"][i, kl])
            mp.y_edge_ind = int(inp["reid"][j, kr])
        elif which == X_MAT:
            c = (code >> 16) & 255
            if c == _BX_NONE:
                mp.y_ind = j
                return mp
            k, move = divmod(c, 3)
            mp.matrix = (X_MAT, Y_MAT, M_MAT)[move]
            mp.x_ind = int(inp["lprev"][i, k])
            mp.y_ind = j
            mp.x_edge_ind = int(inp["leid"][i, k])
        else:
            c = (code >> 24) & 255
            if c == _BY_NONE:
                mp.x_ind = i
                return mp
            k, move = divmod(c, 3)
            mp.matrix = (Y_MAT, X_MAT, M_MAT)[move]
            mp.x_ind = i
            mp.y_ind = int(inp["rprev"][j, k])
            mp.y_edge_ind = int(inp["reid"][j, k])
        return mp


def finish_fanin(job_inp, bp, snaps, ilo, left, right, model, settings,
                 lbl, rbl, kr_decode=None):
    """Host end-corner + backtrack over a filled job."""
    from .viterbi_jax import _backtrack_arrays, _end_corner_arrays

    cells = _FaninCells(bp, ilo, job_inp, left, right, snaps=snaps,
                        kr_decode=kr_decode)
    end = _end_corner_arrays(cells, left, right, model, settings, job_inp)
    if not np.isfinite(end.score):
        return None, None
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, left, right, PathPtr(end, True),
                             job_inp["L"], job_inp["R"], lbl, rbl)
    return path, end


def band_window(inp: dict, band, Lp: int, Rp: int):
    """(W, ilo) of one fan-in fill over an Lp x Rp plane: the band's
    window of W rows starting at row ilo[d] on diagonal d, or the whole
    plane (Lp, 0) when there is no band or its window is as wide.  Sets
    (or clears) inp's band masks to match."""
    L, R = inp["L"], inp["R"]
    D = Lp + Rp - 1
    ilo = np.zeros(D, np.int32)
    if band is None:
        inp.pop("band_upper", None)
        inp.pop("band_lower", None)
        return Lp, ilo
    inp["band_upper"] = np.clip(np.asarray(band[0][:L], np.int64),
                                0, R - 1).astype(np.int32)
    inp["band_lower"] = np.clip(np.asarray(band[1][:L], np.int64),
                                0, R - 1).astype(np.int32)
    from .viterbi_banded import band_windows
    ilo_r, Wreal = band_windows(band[0], band[1], L, R)
    W = _bucket(Wreal)
    if W >= Lp:
        return Lp, ilo
    ilo[:len(ilo_r)] = ilo_r
    ilo[len(ilo_r):] = ilo_r[-1] if len(ilo_r) else 0
    return W, ilo


def fanin_align_path(left: SequenceGraph, right: SequenceGraph,
                     model: EvolModel, settings: AlignSettings,
                     left_branch_length: float = 0.0,
                     right_branch_length: float = 0.0,
                     dtype=np.float64, band=None):
    """Single-pair device fill + host backtrack for fan-in graphs,
    banded when an anchor band is given. Falls back to the full matrix
    if the banded DP dead-ends (viterbi_alignment.cpp:298-317).
    Handles ANY fan-in: bounded-offset graphs take the one-hot scan
    core (the Hopper kernel on a GPU); beyond-cap graphs (deep
    homopolymer runs, K > 8) take the generic gather core.  A band
    runs in its window of W rows per diagonal on either fill, so the
    backpointer plane is D x W, never the dense D x Lp plane."""
    from .backend import fill_impl, count_fill, KERNEL
    inp = prepare_fanin(left, right, model, settings, dtype)
    L, R = inp["L"], inp["R"]
    # bucketed K: reuse one compiled kernel across the K creep
    # (eligibility checks below read the RAW inp values)
    KL, KR = _k_bucket(inp["KL"]), _k_bucket(inp["KR"])
    G = _g_bucket(inp["OL"] + inp["OR"])
    Lp, Rp = _bucket(L), _bucket(R)
    overcap = fanin_overcap(KL, KR, inp["OL"], inp["OR"])

    if fill_impl("fanin", overcap=overcap) == KERNEL:
        from .hopper import fanin_fill

        def run(bnd):
            W, ilo = band_window(inp, bnd, Lp, Rp)
            bp, snaps = fanin_fill([inp], Lp, Rp, KL, KR, W=W, ilo=ilo)
            count_fill(KERNEL)
            return bp[0], tuple(snaps[0]), ilo
    else:
        def run(bnd):
            W, ilo = band_window(inp, bnd, Lp, Rp)
            args = stack_fanin([inp], Lp, Rp, KL, KR, G, W=W, ilo=ilo,
                               dtype=dtype)
            # offsets are static kernel-key dims like K: bucket them so
            # the creep reuses compiled kernels (matches the executor
            # batch path)
            fill = get_fanin_fill(KL, KR, G, W, OLm=_k_bucket(inp["OL"]),
                                  ORm=_k_bucket(inp["OR"]))
            bp, sM, sX, sY = fill(*args)
            count_fill("scan")
            from ..utils import fetch_np
            return (fetch_np(bp)[:, 0, :],
                    (fetch_np(sM)[0], fetch_np(sX)[0], fetch_np(sY)[0]),
                    ilo)

    # the fill packed M codes with stride = bucketed KR, so the decode
    # must use the same KR (raw KR 5 -> bucket 6 would otherwise
    # corrupt every backpointer past the first homopolymer site)
    bp, snaps, ilo = run(band)
    path, end = finish_fanin(inp, bp, snaps, ilo, left, right, model,
                             settings, left_branch_length,
                             right_branch_length, kr_decode=KR)
    if path is None and band is not None:
        bp, snaps, ilo = run(None)
        path, end = finish_fanin(inp, bp, snaps, ilo, left, right, model,
                                 settings, left_branch_length,
                                 right_branch_length, kr_decode=KR)
    if path is None:
        raise RuntimeError("fan-in fill could not reach the end corner")
    return path, end
