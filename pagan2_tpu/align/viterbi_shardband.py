"""Band-axis sharding of ONE pairwise DP across a device mesh.

The sheared wavefront kernel (viterbi_sheared.batched_sheared_core)
processes one anti-diagonal of L lanes per step. For a single giant
pair, this module splits the LANE axis over a `band` mesh axis with
`shard_map`: each device owns a contiguous slice of the left-sequence
rows plus an H-lane halo from its left neighbour. Within-step
dependencies only ever reach one lane to the left (the X/M shifts), so
the halo degrades by one lane per diagonal and a single
`lax.ppermute` of the six wavefront vectors every H diagonals keeps all
owned lanes exact — the collective runs once per H steps instead
of once per step.

The step body is the exact recurrence of batched_sheared_core (same
candidate order, same argmax tie-breaks, same masks), so the
backpointer planes are BIT-IDENTICAL to the 1-device kernel; a test
asserts this on an 8-device CPU mesh.

There is no counterpart in the reference: its DP is strictly
single-threaded per pair (viterbi_alignment.cpp:260-282); the banding
itself mirrors Tunnel_matrix semantics (tunnel_matrix.h:45-152) via the
band_lo/band_hi masks.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..graph.sequence_graph import SequenceGraph
from ..models.evol_model import EvolModel
from .settings import AlignSettings
from .oracle import PathPtr
from .viterbi_sheared import (NEG, _NONE, prepare_sheared, _bucket,
                              _end_corner_linear, _ShearedCells)

# halo width = diagonals between collectives; any positive value is
# exact, larger trades duplicated lanes for fewer permutes
HALO = 32


def _lane_split(L: int, n_dev: int) -> int:
    """Owned lanes per device: bucketed total split evenly, kept a
    multiple of 8."""
    W = _bucket(L)
    w = -(-W // n_dev)
    return -(-w // 8) * 8


def _overlap_shard(vec: np.ndarray, n_dev: int, w: int, H: int, fill):
    """(W,) -> (n_dev*(H+w),) where device k's chunk is
    [k*w - H, k*w + w) of the global lane axis (halo + owned)."""
    wloc = H + w
    out = np.full(n_dev * wloc, fill, vec.dtype)
    for k in range(n_dev):
        lo = k * w - H
        seg = np.full(wloc, fill, vec.dtype)
        src_lo = max(lo, 0)
        src_hi = min(k * w + w, len(vec))
        if src_hi > src_lo:
            seg[src_lo - lo:src_hi - lo] = vec[src_lo:src_hi]
        out[k * wloc:(k + 1) * wloc] = seg
    return out


def _overlap_shard2(arr: np.ndarray, n_dev: int, w: int, H: int, fill):
    """(W, C) row-sharded variant of _overlap_shard."""
    wloc = H + w
    C = arr.shape[1]
    out = np.full((n_dev * wloc, C), fill, arr.dtype)
    for k in range(n_dev):
        lo = k * w - H
        src_lo = max(lo, 0)
        src_hi = min(k * w + w, arr.shape[0])
        if src_hi > src_lo:
            out[k * wloc + (src_lo - lo):
                k * wloc + (src_hi - lo)] = arr[src_lo:src_hi]
    return out


def _build_fill(mesh: Mesh, H: int):
    """Jitted shard_map fill for a ('band', n) mesh."""
    n_dev = int(np.prod(mesh.devices.shape))

    def fill(TL_ov, rs_rext, gj_rext, orp_rext, rw_rext, gexti_ov, olp_ov,
             lw_ov, vlo_ov, vhi_ov, scal, iscal, blocks):
        # local views: TL_ov (wloc, nf) log-score row of each lane's
        # left state; *_ov (wloc,); rext vectors and blocks (the
        # indices of the H-diagonal blocks) replicated
        wloc = TL_ov.shape[0]
        w = wloc - H
        f = TL_ov.dtype
        big_neg = jnp.array(NEG, f)
        k = lax.axis_index("band")
        lng, lgo = scal[0], scal[1]
        Ldp, Rdp, slice_base = iscal[0], iscal[1], iscal[2]
        corner_d = Ldp + Rdp - 2

        li = jnp.arange(wloc)
        ii = k * w - H + li                     # global lane index
        owned = li >= H
        corner_onehot = (ii == Ldp - 1) & owned

        perm = [(i, i + 1) for i in range(n_dev - 1)]

        def shift(v):
            return jnp.concatenate([jnp.full((1,), big_neg, f), v[:-1]])

        def refresh(states):
            """Pull the left neighbour's rightmost H owned lanes into
            the halo (one ppermute for all six vectors)."""
            edges = jnp.stack([v[-H:] for v in states])
            halo = lax.ppermute(edges, "band", perm)
            halo = jnp.where(k == 0, big_neg, halo)
            return tuple(
                jnp.concatenate([halo[s], states[s][H:]])
                for s in range(6))

        def block(carry, b):
            states = refresh(carry)
            M1, X1, Y1, M2, X2, Y2 = states
            bps = []
            final_upd = jnp.full((3,), big_neg, f)
            have_hit = jnp.array(False)
            for t in range(H):
                d = 1 + b * H + t
                # j-indexed rows: value[l] = vec[d - ii[l]]; the rext
                # vectors carry H extra front zeros so the slice start
                # (clamped on padded diagonals, which are fully masked)
                # stays in range for every shard
                start = slice_base - d + k * w
                rs = lax.dynamic_slice_in_dim(rs_rext, start, wloc)
                ms = jnp.take_along_axis(TL_ov, rs[:, None], axis=1)[:, 0]
                gj = lax.dynamic_slice_in_dim(gj_rext, start, wloc)
                orp = lax.dynamic_slice_in_dim(orp_rext, start, wloc)
                rw = lax.dynamic_slice_in_dim(rw_rext, start, wloc)
                jjj = d - ii
                valid = (jjj >= 0) & (jjj < Rdp) & (ii < Ldp) & \
                    (jjj >= vlo_ov) & (jjj <= vhi_ov)

                M1s, X1s, Y1s = shift(M1), shift(X1), shift(Y1)
                M2s, X2s, Y2s = shift(M2), shift(X2), shift(Y2)

                cx = jnp.stack([X1s + gj, Y1s + lgo, M1s + lng + olp_ov])
                bpx = jnp.argmax(cx, axis=0).astype(jnp.int32)
                vx = jnp.max(cx, axis=0)
                okx = valid & (ii > 0) & jnp.isfinite(vx)
                X = jnp.where(okx, vx, big_neg)
                bpx = jnp.where(okx, bpx, _NONE)

                cy = jnp.stack([Y1 + gexti_ov, X1 + lgo, M1 + lng + orp])
                bpy = jnp.argmax(cy, axis=0).astype(jnp.int32)
                vy = jnp.max(cy, axis=0)
                oky = valid & (jjj > 0) & jnp.isfinite(vy)
                Y = jnp.where(oky, vy, big_neg)
                bpy = jnp.where(oky, bpy, _NONE)

                wadd = lng + ms + lw_ov + rw
                cm = jnp.stack([M2s + lng + wadd, X2s + wadd, Y2s + wadd])
                bpm = jnp.argmax(cm, axis=0).astype(jnp.int32)
                vm = jnp.max(cm, axis=0)
                okm = valid & (ii > 0) & (jjj > 0) & jnp.isfinite(vm)
                M = jnp.where(okm, vm, big_neg)
                bpm = jnp.where(okm, bpm, _NONE)

                bps.append((bpm | (bpx << 2) | (bpy << 4)).astype(jnp.int8))

                hit = d == corner_d
                cap = jnp.stack(
                    [jnp.where(corner_onehot, M, 0).sum(),
                     jnp.where(corner_onehot, X, 0).sum(),
                     jnp.where(corner_onehot, Y, 0).sum()])
                # only the device owning the corner lane contributes;
                # the all-zero masked sum on the others must not win
                # the cross-device pmax
                cap = jnp.where(corner_onehot.any(), cap, big_neg)
                final_upd = jnp.where(hit, cap, final_upd)
                have_hit = have_hit | hit

                M2, X2, Y2 = M1, X1, Y1
                M1, X1, Y1 = M, X, Y

            bp_blk = jnp.stack(bps)[:, H:]      # owned lanes only
            return (M1, X1, Y1, M2, X2, Y2), (bp_blk, final_upd, have_hit)

        # derive the -inf init from ii (0 * ii keeps it -inf) so every
        # carry is device-varying from the start — newer shard_map
        # rejects scan carries that switch from replicated to varying
        allneg = big_neg + 0.0 * ii.astype(f)
        M1 = jnp.where(ii == 0, jnp.zeros((wloc,), f), allneg)
        init = (M1, allneg, allneg, allneg, allneg, allneg)

        _, (bp_blocks, finals, hits) = lax.scan(block, init, blocks)
        bp = bp_blocks.reshape(blocks.shape[0] * H, w)
        # the corner diagonal lands in exactly one block; pick that
        # block's capture, then resolve the owner across devices
        fin = jnp.where(hits[:, None], finals, big_neg)
        final_local = jnp.max(fin, axis=0)
        final = lax.pmax(final_local, "band")
        return bp, final

    specs = dict(
        in_specs=(P("band"), P(), P(), P(), P(), P("band"),
                  P("band"), P("band"), P("band"), P("band"),
                  P(), P(), P()),
        out_specs=(P(None, "band"), P()))
    try:
        from jax import shard_map
        sm = shard_map(fill, mesh=mesh, **specs)
    except (ImportError, TypeError):   # older jax: check_rep API
        from jax.experimental.shard_map import shard_map as shard_map_old
        sm = shard_map_old(fill, mesh=mesh, check_rep=False, **specs)
    return jax.jit(sm)


_fill_cache: dict = {}


def shardband_fill(mesh: Mesh, args, H: int = HALO):
    key = (mesh, H)
    if key not in _fill_cache:
        _fill_cache[key] = _build_fill(mesh, H)
    return _fill_cache[key](*args)


def shardband_args(left: SequenceGraph, right: SequenceGraph,
                   model: EvolModel, settings: AlignSettings,
                   n_dev: int, band=None, dtype=np.float64, H: int = HALO):
    """Host prep: overlapped lane shards + replicated rext vectors,
    all O(L + R): each lane carries the log-score row of its left
    state and the fill looks match scores up by the right state, so no
    O(L x R) table is built on the host or on any one device."""
    inp = prepare_sheared(left, right, model, settings, dtype,
                          with_ms=False)
    L, R = inp["L"], inp["R"]
    w = _lane_split(L, n_dev)
    W = w * n_dev
    Rp = _bucket(R)
    Dn = W + Rp - 2
    Dpk = -(-Dn // H) * H

    # states index the table python-style, as prepare_sheared's
    # log_score[np.ix_(lstates, rstates)] does
    nf = model.log_score.shape[0]
    TL = np.zeros((W, nf), dtype)
    TL[:L] = model.log_score[np.asarray(left.states[:L], np.int64)]
    rstates = np.mod(np.asarray(right.states[:R], np.int64), nf)

    # overlapped (halo+owned) per-lane shards
    def ov(vec, fill=0.0, dt=None):
        v = np.zeros(W, dt or dtype)
        v[:len(vec)] = vec
        if fill and len(vec) < W:
            v[len(vec):] = fill
        return _overlap_shard(v, n_dev, w, H, v.dtype.type(fill))

    gexti = ov(inp["gext_i"])
    olp = ov(np.concatenate([[0.0], inp["open_l"][:-1]]).astype(dtype))
    lw = ov(inp["lw"])
    if band is None:
        vlo = np.zeros(L, np.int32)
        vhi = np.full(L, R - 1, np.int32)
    else:
        vlo = np.asarray(band[0][:L], np.int32)
        vhi = np.asarray(band[1][:L], np.int32)
    # out-of-range lanes: empty interval
    vlo_f = np.full(W, 1, np.int32)
    vlo_f[:L] = vlo
    vhi_f = np.full(W, 0, np.int32)
    vhi_f[:L] = vhi
    vlo_ov = _overlap_shard(vlo_f, n_dev, w, H, np.int32(1))
    vhi_ov = _overlap_shard(vhi_f, n_dev, w, H, np.int32(0))

    # reversed column vectors with H extra front zeros so sharded
    # slice starts stay non-negative
    def rext(vec, dt=dtype):
        v = np.zeros(Rp, dt)
        v[:len(vec)] = vec
        return jnp.asarray(np.concatenate(
            [np.zeros(H, dt), np.zeros(W - 1, dt), v[::-1],
             np.zeros(W, dt)]))

    rs_rext = rext(rstates, np.int32)
    gj_rext = rext(inp["gext_j"])
    orp_rext = rext(inp["open_r_shifted"])
    rw_rext = rext(inp["rw"])

    scal = jnp.asarray(np.array([inp["lng"], inp["lgo"]], dtype))
    # slice_base = W + Rp - 2: with rext()'s layout ([H zeros][W-1
    # zeros][Rp reversed][W zeros]) the in-kernel slice start
    # slice_base - d + k*w lands value vec[d - ii[l]] on local lane l,
    # and stays >= 0 for every real diagonal (the H front zeros absorb
    # the halo offset; only fully-masked padded diagonals clamp)
    iscal = jnp.asarray(np.array([L, R, W + Rp - 2], np.int32))
    args = (jnp.asarray(_overlap_shard2(TL, n_dev, w, H, 0.0)), rs_rext,
            gj_rext, orp_rext, rw_rext,
            jnp.asarray(gexti), jnp.asarray(olp), jnp.asarray(lw),
            jnp.asarray(vlo_ov), jnp.asarray(vhi_ov), scal, iscal,
            jnp.arange(Dpk // H, dtype=jnp.int32))
    return args, dict(L=L, R=R, w=w, W=W, Dpk=Dpk, inp=inp)


def shardband_align_path(left: SequenceGraph, right: SequenceGraph,
                         model: EvolModel, settings: AlignSettings,
                         mesh: Mesh,
                         left_branch_length: float = 0.0,
                         right_branch_length: float = 0.0,
                         band=None, dtype=np.float64, H: int = HALO):
    """Sharded fill + host backtrack for one giant pair. Bit-identical
    to sheared_align_path; falls back to the full matrix when a band
    cannot reach the end corner (viterbi_alignment.cpp:298-317)."""
    from .viterbi_jax import _backtrack_arrays
    n_dev = int(np.prod(mesh.devices.shape))
    # the halo refresh pulls the neighbour's last H lanes, which are
    # only exact when every device owns at least H lanes
    H = min(H, _lane_split(left.num_sites() - 1, n_dev))

    def run(bnd):
        args, meta = shardband_args(left, right, model, settings, n_dev,
                                    band=bnd, dtype=dtype, H=H)
        bp, final = shardband_fill(mesh, args, H=H)
        return np.asarray(bp), np.asarray(final), meta

    bp, final, meta = run(band)
    if band is not None and not np.isfinite(final).any():
        bp, final, meta = run(None)

    # prepend the d=0 row to match the sheared layout
    bp_full = np.concatenate(
        [np.full((1, bp.shape[1]), _NONE | (_NONE << 2) | (_NONE << 4),
                 np.int8), bp], axis=0)
    cells = _ShearedCells(bp_full, left, right)
    end = _end_corner_linear(final, left, right, model,
                             meta["L"], meta["R"])
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, left, right, PathPtr(end, True),
                             meta["L"], meta["R"],
                             left_branch_length, right_branch_length)
    return path, end


# ----------------------------------------------------------------------
# band-axis sharding for FAN-IN graph pairs (454/homopolymer reads,
# ancestors with indel bridges): a giant deep ancestor of a megabase
# family can ride the mesh too. The recurrence is the one-hot fan-in
# scan core's (viterbi_fanin._build_core_onehot — same candidate order,
# same strict-greater first-wins codes, so finish_fanin backtracks the
# sharded fill unchanged), with the ring of the last G diagonals lane-
# sharded. Edge offsets reach OLm lanes to the left, so the halo
# degrades by OLm lanes per diagonal and the ppermute refresh runs
# every H // OLm steps (the linear fill's every-H cadence at OLm=1).
# ----------------------------------------------------------------------
def _build_fanin_fill(mesh: Mesh, H: int, KL: int, KR: int, OLm: int,
                      ORm: int, G: int, nf: int, Dn: int):
    from .viterbi_fanin import _BM_NONE, _BX_NONE, _BY_NONE
    n_dev = int(np.prod(mesh.devices.shape))
    Gm = min(G, OLm + ORm)
    T = max(1, H // max(OLm, 1))     # steps between halo refreshes

    def fill(TL_ov, loff_ov, llw_ov, lopen_ov, gexti_ov, vlo_ov,
             vhi_ov, rs_rev, gjx_rev, roff_rev, rlw_rev, ropen_rev,
             scal, iscal):
        wloc = TL_ov.shape[0]
        w = wloc - H
        f = TL_ov.dtype
        neg = jnp.array(NEG, f)
        k = lax.axis_index("band")
        lng, lgo = scal[0], scal[1]
        Ldp, Rdp, Base = iscal[0], iscal[1], iscal[2]
        corner_d = Ldp + Rdp - 2
        li = jnp.arange(wloc)
        ii = k * w - H + li
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        negv = jnp.full((wloc,), neg, f)

        def sh(v, s):
            if s == 0:
                return v
            return jnp.concatenate([jnp.full((s,), neg, f), v[:-s]])

        def refresh(rM, rX, rY):
            edges = jnp.concatenate(
                [rM[:, -H:], rX[:, -H:], rY[:, -H:]], axis=0)
            halo = lax.ppermute(edges, "band", perm)
            halo = jnp.where(k == 0, neg, halo)
            rM = jnp.concatenate([halo[:G], rM[:, H:]], axis=1)
            rX = jnp.concatenate([halo[G:2 * G], rX[:, H:]], axis=1)
            rY = jnp.concatenate([halo[2 * G:], rY[:, H:]], axis=1)
            return rM, rX, rY

        def one_step(rM, rX, rY, sM, sX, sY, d):
            start = jnp.maximum(Base - d + k * w - H, 0)
            rs = lax.dynamic_slice_in_dim(rs_rev, start, wloc)
            gjx = lax.dynamic_slice_in_dim(gjx_rev, start, wloc)
            roff = lax.dynamic_slice_in_dim(roff_rev, start, wloc,
                                            axis=1)
            rlw = lax.dynamic_slice_in_dim(rlw_rev, start, wloc,
                                           axis=1)
            ropen = lax.dynamic_slice_in_dim(ropen_rev, start, wloc,
                                             axis=1)
            jj = d - ii
            valid = (jj >= 0) & (jj < Rdp) & (ii < Ldp) & (ii >= 0) & \
                (jj >= vlo_ov) & (jj <= vhi_ov)
            ms = jnp.take_along_axis(
                TL_ov, jnp.clip(rs, 0, nf - 1)[:, None], axis=1)[:, 0]

            AM = [None] + [rM[g - 1] for g in range(1, Gm + 1)]
            AX = [None] + [rX[g - 1] for g in range(1, Gm + 1)]
            AY = [None] + [rY[g - 1] for g in range(1, Gm + 1)]

            def upd(best, code, cand, c):
                take = cand > best
                return (jnp.where(take, cand, best),
                        jnp.where(take, c, code))

            # ---- X: gap consuming left site i ----
            bestX = negv
            codeX = jnp.full((wloc,), _BX_NONE, jnp.int32)
            shx = [None] + [sh(AX[g], g)
                            for g in range(1, min(OLm, Gm) + 1)]
            shy = [None] + [sh(AY[g], g)
                            for g in range(1, min(OLm, Gm) + 1)]
            shm = [None] + [sh(AM[g], g)
                            for g in range(1, min(OLm, Gm) + 1)]
            for kk in range(KL):
                o = loff_ov[:, kk]
                gx = gy = gm = negv
                for g in range(1, min(OLm, Gm) + 1):
                    m = o == g
                    gx = jnp.where(m, shx[g], gx)
                    gy = jnp.where(m, shy[g], gy)
                    gm = jnp.where(m, shm[g], gm)
                bestX, codeX = upd(bestX, codeX, gx + gjx, kk * 3)
                bestX, codeX = upd(bestX, codeX, gy + lgo, kk * 3 + 1)
                bestX, codeX = upd(bestX, codeX,
                                   gm + lng + lopen_ov[:, kk],
                                   kk * 3 + 2)

            # ---- Y: gap consuming right site j (no lane shift) ----
            bestY = negv
            codeY = jnp.full((wloc,), _BY_NONE, jnp.int32)
            for kk in range(KR):
                o = roff[kk]
                gy = gx = gm = negv
                for g in range(1, min(ORm, Gm) + 1):
                    m = o == g
                    gy = jnp.where(m, AY[g], gy)
                    gx = jnp.where(m, AX[g], gx)
                    gm = jnp.where(m, AM[g], gm)
                bestY, codeY = upd(bestY, codeY, gy + gexti_ov,
                                   kk * 3)
                bestY, codeY = upd(bestY, codeY, gx + lgo, kk * 3 + 1)
                bestY, codeY = upd(bestY, codeY,
                                   gm + lng + ropen[kk], kk * 3 + 2)

            # ---- M: match consuming both ----
            bestM = negv
            codeM = jnp.full((wloc,), _BM_NONE, jnp.int32)
            mbase = lng + ms
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
                ol = loff_ov[:, kl]
                lw = llw_ov[:, kl]
                lmask = [None] + [ol == s for s in range(1, OLm + 1)]
                for kr in range(KR):
                    orr = roff[kr]
                    gm = gx = gy = negv
                    for s in range(1, OLm + 1):
                        for r in range(1, ORm + 1):
                            if s + r > Gm:
                                continue
                            mm = lmask[s] & (orr == r)
                            gm = jnp.where(mm, shM[(s, s + r)], gm)
                            gx = jnp.where(mm, shX2[(s, s + r)], gx)
                            gy = jnp.where(mm, shY2[(s, s + r)], gy)
                    base = mbase + lw + rlw[kr]
                    c0 = (kl * KR + kr) * 3
                    bestM, codeM = upd(bestM, codeM, gm + lng + base,
                                       c0)
                    bestM, codeM = upd(bestM, codeM, gx + base, c0 + 1)
                    bestM, codeM = upd(bestM, codeM, gy + base, c0 + 2)

            okx = valid & (ii > 0) & jnp.isfinite(bestX)
            oky = valid & (jj > 0) & jnp.isfinite(bestY)
            okm = valid & (ii > 0) & (jj > 0) & jnp.isfinite(bestM)
            X = jnp.where(okx, bestX, neg)
            Y = jnp.where(oky, bestY, neg)
            M = jnp.where(okm, bestM, neg)
            seed = (ii == 0) & (jj == 0)
            M = jnp.where(seed, jnp.zeros((), f), M)

            bp = (jnp.where(okm, codeM, _BM_NONE) +
                  (jnp.where(okx, codeX, _BX_NONE) << 16) +
                  (jnp.where(oky, codeY, _BY_NONE) << 24)
                  ).astype(jnp.uint32)

            rM = jnp.concatenate([M[None], rM[:-1]], axis=0)
            rX = jnp.concatenate([X[None], rX[:-1]], axis=0)
            rY = jnp.concatenate([Y[None], rY[:-1]], axis=0)
            hit = d == corner_d
            sM = jnp.where(hit, rM, sM)
            sX = jnp.where(hit, rX, sX)
            sY = jnp.where(hit, rY, sY)
            return rM, rX, rY, sM, sX, sY, bp

        def block(carry, db):
            rM, rX, rY, sM, sX, sY = carry
            rM, rX, rY = refresh(rM, rX, rY)
            bps = []
            for t in range(T):
                d = db * T + t
                rM, rX, rY, sM, sX, sY, bp = one_step(
                    rM, rX, rY, sM, sX, sY, d)
                bps.append(bp)
            return (rM, rX, rY, sM, sX, sY), jnp.stack(bps)

        # device-varying -inf init (0*ii) so scan carries never switch
        # from replicated to varying
        ring0 = neg + 0.0 * ii.astype(f)[None, :] + \
            jnp.zeros((G, 1), f)
        init = (ring0, ring0, ring0, ring0, ring0, ring0)
        nblk = -(-Dn // T)
        (rM, rX, rY, sM, sX, sY), bp_blocks = lax.scan(
            block, init, jnp.arange(nblk))
        bp = bp_blocks.reshape(nblk * T, wloc)[:, H:]
        return bp, sM[:, H:], sX[:, H:], sY[:, H:]

    specs = dict(
        in_specs=(P("band"), P("band"), P("band"), P("band"),
                  P("band"), P("band"), P("band"),
                  P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(None, "band"), P(None, "band"), P(None, "band"),
                   P(None, "band")))

    try:
        from jax import shard_map
        sm = shard_map(fill, mesh=mesh, **specs)
    except (ImportError, TypeError):
        from jax.experimental.shard_map import shard_map as sm_old
        sm = sm_old(fill, mesh=mesh, check_rep=False, **specs)
    return jax.jit(sm)


_fanin_fill_cache: dict = {}


def shardband_fanin_align_path(left: SequenceGraph,
                               right: SequenceGraph,
                               model: EvolModel,
                               settings: AlignSettings, mesh: Mesh,
                               left_branch_length: float = 0.0,
                               right_branch_length: float = 0.0,
                               band=None, dtype=np.float64,
                               H: int = HALO):
    """Band-axis-sharded fill + host backtrack for one giant FAN-IN
    pair; bit-identical to the one-hot fan-in scan core. Falls back to
    the full matrix when a band dead-ends."""
    from .viterbi_fanin import (prepare_fanin, finish_fanin, _g_bucket,
                                K_CAP)
    n_dev = int(np.prod(mesh.devices.shape))
    inp = prepare_fanin(left, right, model, settings, dtype)
    L, R = inp["L"], inp["R"]
    H = min(H, _lane_split(L, n_dev))
    KL, KR = inp["KL"], inp["KR"]
    OLm, ORm = max(inp["OL"], 1), max(inp["OR"], 1)
    G = _g_bucket(OLm + ORm)
    if KL > K_CAP or KR > K_CAP:
        raise ValueError("fan-in beyond the one-hot caps")
    # halo budget: the fill refreshes cross-shard lanes every
    # T = max(1, H // OLm) steps, which assumes one step consumes at
    # most OLm <= H halo lanes; a LEFT bridge edge spanning more than
    # H sites would read -inf/stale values PAST the refreshed halo and
    # silently diverge from the unsharded fill.  Right offsets only
    # select ring DEPTH (plane d-s-r) and the refresh transfers every
    # ring plane's halo lanes, so ORm needs no lane budget.  The
    # executor catches ValueError and routes such pairs to the
    # single-device path.
    if OLm > H:
        raise ValueError(
            "left bridge offset %d exceeds the %d-lane halo budget"
            % (OLm, H))
    nf = inp["log_score"].shape[0]
    w = _lane_split(L, n_dev)
    Wt = w * n_dev
    Rp = _bucket(R)
    Dn = Wt + Rp - 1

    def run(bnd):
        # ---- host prep: overlapped lane shards + replicated revs ----
        TL = np.zeros((Wt, nf), dtype)
        TL[:L] = inp["log_score"][inp["lstates"]]
        loff = np.zeros((Wt, KL), np.int32)
        loff[:L] = inp["loff"]
        llw = np.zeros((Wt, KL), dtype)
        llw[:L] = inp["llw"]
        lopen = np.zeros((Wt, KL), dtype)
        lopen[:L] = inp["lopen"]
        gexti = np.zeros(Wt, dtype)
        gexti[:L] = inp["gext_i"]
        if bnd is None:
            vlo = np.zeros(L, np.int32)
            vhi = np.full(L, R - 1, np.int32)
        else:
            vlo = np.clip(np.asarray(bnd[0][:L], np.int64), 0,
                          R - 1).astype(np.int32)
            vhi = np.clip(np.asarray(bnd[1][:L], np.int64), 0,
                          R - 1).astype(np.int32)
        vlo_f = np.full(Wt, 1, np.int32)
        vlo_f[:L] = vlo
        vhi_f = np.full(Wt, 0, np.int32)
        vhi_f[:L] = vhi

        Base = Dn - 1 + H
        Ext = Base + Wt + H + 1

        def rev(vec, fill, dt):
            out = np.full(Ext, fill, dt)
            n = len(vec)
            # out[q] = vec[Base - q]
            q = Base - np.arange(n)
            out[q] = vec
            return out

        rs_rev = rev(inp["rstates"], nf, np.int32)
        gjx_rev = rev(inp["gext_j"], 0.0, dtype)
        roff_rev = np.stack([rev(inp["roff"][:, kk], 0, np.int32)
                             for kk in range(KR)])
        rlw_rev = np.stack([rev(inp["rlw"][:, kk], 0.0, dtype)
                            for kk in range(KR)])
        ropen_rev = np.stack([rev(inp["ropen"][:, kk], 0.0, dtype)
                              for kk in range(KR)])
        scal = np.array([inp["lng"], inp["lgo"]], dtype)
        iscal = np.array([L, R, Base], np.int32)

        args = (
            jnp.asarray(_overlap_shard2(TL, n_dev, w, H, 0.0)),
            jnp.asarray(_overlap_shard2(loff, n_dev, w, H,
                                        np.int32(0))),
            jnp.asarray(_overlap_shard2(llw, n_dev, w, H, 0.0)),
            jnp.asarray(_overlap_shard2(lopen, n_dev, w, H, 0.0)),
            jnp.asarray(_overlap_shard(gexti, n_dev, w, H, 0.0)),
            jnp.asarray(_overlap_shard(vlo_f, n_dev, w, H,
                                       np.int32(1))),
            jnp.asarray(_overlap_shard(vhi_f, n_dev, w, H,
                                       np.int32(0))),
            jnp.asarray(rs_rev), jnp.asarray(gjx_rev),
            jnp.asarray(roff_rev), jnp.asarray(rlw_rev),
            jnp.asarray(ropen_rev), jnp.asarray(scal),
            jnp.asarray(iscal))
        key = (mesh, H, KL, KR, OLm, ORm, G, nf, Dn, dtype)
        if key not in _fanin_fill_cache:
            _fanin_fill_cache[key] = _build_fanin_fill(
                mesh, H, KL, KR, OLm, ORm, G, nf, Dn)
        bp, sM, sX, sY = _fanin_fill_cache[key](*args)
        return (np.asarray(bp), (np.asarray(sM), np.asarray(sX),
                                 np.asarray(sY)))

    D = L + R - 1
    ilo = np.zeros(max(D, Dn), np.int32)
    bp, snaps = run(band)
    path, end = finish_fanin(inp, bp, snaps, ilo, left, right, model,
                             settings, left_branch_length,
                             right_branch_length, kr_decode=KR)
    if path is None and band is not None:
        bp, snaps = run(None)
        path, end = finish_fanin(inp, bp, snaps, ilo, left, right,
                                 model, settings, left_branch_length,
                                 right_branch_length, kr_decode=KR)
    return path, end
