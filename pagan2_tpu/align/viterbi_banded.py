"""Windowed banded wavefront DP: O(D x W) memory for anchored pairs.

The tunnel bounds from anchoring are monotone, so the in-band rows on
every anti-diagonal form one contiguous window. This kernel carries only
that window (width = max band width, bucketed) across the diagonal scan:
HBM holds the int8 backpointer stripe (D x W) and O(L) vectors — a
100-500 kb anchored pair fits in bounded memory, which is the
reference's Tunnel_matrix story (tunnel_matrix.h:45-152) done the
wavefront way (the band rides the wavefront instead of per-row slices).

Match scores are built in-scan from the state vectors with a one-hot
contraction, so no O(L*R) table exists anywhere. DNA's 15-state
alphabet costs ~30 element-wise ops/cell; larger alphabets pay
proportionally.
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
from .viterbi_sheared import (_NONE, prepare_sheared, _end_corner_linear,
                              _bucket)

NEG = -np.inf


# ----------------------------------------------------------------------
def band_schedule(upper: np.ndarray, lower: np.ndarray, L: int, R: int):
    """Per-diagonal window start ilo[d] and in-band width w[d] from
    monotone tunnel bounds — THE shared schedule derivation (the
    windowed scan cores and the Hopper band fill both consume it).

    A[i] = i + upper[i] and B[i] = i + lower[i] are non-decreasing, so
    ilo(d) = first i with B[i] >= d and ihi(d) = last i with A[i] <= d
    bound the contiguous in-band row range of diagonal d.  Width comes
    from the UNCLIPPED indices: clipping first would count rows whose
    own band excludes the diagonal (a corner-cutting band must produce
    w=0 there so the -inf corner triggers the fallback)."""
    upper = np.clip(np.asarray(upper[:L], np.int64), 0, R - 1)
    lower = np.clip(np.asarray(lower[:L], np.int64), 0, R - 1)
    i = np.arange(L, dtype=np.int64)
    A = i + upper
    B = i + lower
    D = L + R - 1
    ds = np.arange(D, dtype=np.int64)
    ilo_u = np.searchsorted(B, ds, side="left")
    ihi_u = np.searchsorted(A, ds, side="right") - 1
    w = np.maximum(ihi_u - ilo_u + 1, 0)
    ilo = np.clip(ilo_u, 0, L - 1)
    return ilo.astype(np.int32), w.astype(np.int32)


def band_windows(upper: np.ndarray, lower: np.ndarray, L: int, R: int):
    """(per-diagonal window starts, max width) for the windowed scan
    cores — band_schedule with the width collapsed to its maximum."""
    ilo, w = band_schedule(upper, lower, L, R)
    return ilo, int(w.max()) if len(w) else 1


# ----------------------------------------------------------------------
def _build_core(W: int):
    """Banded fill core for a fixed window width. All other dimensions
    (diagonal count, row padding, rext offset) are carried by the
    bucketed array shapes / traced scalars so one compilation serves
    every pair whose bucket matches."""

    def core(TL, rs_rext, gj_rext, orp_rext, rw_rext, gext_i_ext,
             open_l_prev_ext, lw_ext, upper_ext, lower_ext,
             ilo_arr, lng, lgo, Ldp, Rdp, RextOff):
        Lpad, nf = TL.shape
        f = TL.dtype
        big_neg = jnp.array(NEG, f)

        tt = jnp.arange(W)
        nf_iota = jnp.arange(nf)[None, :]

        M1 = jnp.full((W,), big_neg, f)
        X1 = jnp.full((W,), big_neg, f)
        Y1 = jnp.full((W,), big_neg, f)
        M2 = jnp.full((W,), big_neg, f)
        X2 = jnp.full((W,), big_neg, f)
        Y2 = jnp.full((W,), big_neg, f)
        final = jnp.full((3,), big_neg, f)

        def window_rows(vec_ext, ilo):
            return lax.dynamic_slice(vec_ext, (ilo,), (W,))

        def rev_cols(vec_rext, d, ilo):
            # lane t -> vec[(d - ilo) - t]
            start = RextOff - (d - ilo)
            return lax.dynamic_slice(vec_rext, (start,), (W,))

        def from_prev(v, delta, minus_one, big=big_neg):
            """Value of the previous-diagonal window at source row
            iig-1 (minus_one) or iig, where the previous window started
            `delta` rows earlier."""
            if minus_one:
                vp = jnp.concatenate(
                    [jnp.full((1,), big, v.dtype), v,
                     jnp.full((W,), big, v.dtype)])
                start = delta          # vp[start+t] = v[t+delta-1]
            else:
                vp = jnp.concatenate(
                    [v, jnp.full((W,), big, v.dtype)])
                start = delta          # vp[start+t] = v[t+delta]
            return lax.dynamic_slice(vp, (start,), (W,))

        def step(carry, xs):
            M1, X1, Y1, M2, X2, Y2, final = carry
            d, ilo, d1, d2 = xs

            iig = ilo + tt                 # global row per lane
            jj = d - iig                   # global column per lane

            up = window_rows(upper_ext, ilo)
            lo = window_rows(lower_ext, ilo)
            valid = (jj >= 0) & (jj < Rdp) & (iig < Ldp) & \
                (jj >= up) & (jj <= lo)

            gext_i = window_rows(gext_i_ext, ilo)
            open_l_prev = window_rows(open_l_prev_ext, ilo)
            lw = window_rows(lw_ext, ilo)
            gj = rev_cols(gj_rext, d, ilo)
            orp = rev_cols(orp_rext, d, ilo)
            rw = rev_cols(rw_rext, d, ilo)

            # match scores from one-hot contraction over the alphabet
            TLw = lax.dynamic_slice(TL, (ilo, jnp.zeros((), ilo.dtype)),
                                    (W, nf))
            rs_w = rev_cols(rs_rext, d, ilo)
            onehot = rs_w[:, None] == nf_iota
            ms = jnp.where(onehot, TLw, 0).sum(axis=1)

            X1s = from_prev(X1, d1, True)
            Y1s = from_prev(Y1, d1, True)
            M1s = from_prev(M1, d1, True)
            X1o = from_prev(X1, d1, False)
            Y1o = from_prev(Y1, d1, False)
            M1o = from_prev(M1, d1, False)
            M2s = from_prev(M2, d2, True)
            X2s = from_prev(X2, d2, True)
            Y2s = from_prev(Y2, d2, True)

            # X: gap in left (ext, double, open)
            cx = jnp.stack([X1s + gj, Y1s + lgo, M1s + lng + open_l_prev])
            bpx = jnp.argmax(cx, axis=0).astype(jnp.int32)
            vx = jnp.max(cx, axis=0)
            okx = valid & (iig > 0) & jnp.isfinite(vx)
            X = jnp.where(okx, vx, big_neg)
            bpx = jnp.where(okx, bpx, _NONE)

            # Y: gap in right (ext, double, open)
            cy = jnp.stack([Y1o + gext_i, X1o + lgo, M1o + lng + orp])
            bpy = jnp.argmax(cy, axis=0).astype(jnp.int32)
            vy = jnp.max(cy, axis=0)
            oky = valid & (jj > 0) & jnp.isfinite(vy)
            Y = jnp.where(oky, vy, big_neg)
            bpy = jnp.where(oky, bpy, _NONE)

            # M: match (m, x, y)
            wadd = lng + ms + lw + rw
            cm = jnp.stack([M2s + lng + wadd, X2s + wadd, Y2s + wadd])
            bpm = jnp.argmax(cm, axis=0).astype(jnp.int32)
            vm = jnp.max(cm, axis=0)
            okm = valid & (iig > 0) & (jj > 0) & jnp.isfinite(vm)
            M = jnp.where(okm, vm, big_neg)
            bpm = jnp.where(okm, bpm, _NONE)

            # seed cell (0, 0)
            seed = (iig == 0) & (jj == 0)
            M = jnp.where(seed, 0.0, M)

            bp = (bpm | (bpx << 2) | (bpy << 4)).astype(jnp.int8)

            hit = d == (Ldp + Rdp - 2)
            oh = (iig == Ldp - 1) & hit
            cap = jnp.stack([jnp.where(oh, M, 0).sum(),
                             jnp.where(oh, X, 0).sum(),
                             jnp.where(oh, Y, 0).sum()])
            final = jnp.where(hit, cap, final)

            return (M, X, Y, M1, X1, Y1, final), bp

        D = ilo_arr.shape[0]
        ds = jnp.arange(D)
        d1 = jnp.diff(ilo_arr, prepend=ilo_arr[:1])
        ilo_m2 = jnp.concatenate([ilo_arr[:1], ilo_arr[:1], ilo_arr[:-2]])
        d2 = ilo_arr - ilo_m2
        carry, bps = lax.scan(step, (M1, X1, Y1, M2, X2, Y2, final),
                              (ds, ilo_arr, d1, d2))
        return bps, carry[-1]

    return core


_banded_cache: dict = {}


def _get_banded_fill(W: int):
    if W not in _banded_cache:
        _banded_cache[W] = jax.jit(_build_core(W))
    return _banded_cache[W]


# ----------------------------------------------------------------------
class _BandedCells:
    """Cell accessor over the (D, W) bp stripe + per-diagonal offsets."""

    def __init__(self, bp, ilo, left, right):
        self.bp = np.asarray(bp)
        self.ilo = np.asarray(ilo)
        self.W = self.bp.shape[1]
        self.left = left
        self.right = right

    def _code(self, i, j):
        d = i + j
        t = i - int(self.ilo[d])
        if t < 0 or t >= self.W:
            return _NONE | (_NONE << 2) | (_NONE << 4)
        return int(self.bp[d, t])

    def cell(self, which, i, j) -> MatrixPtr:
        code = self._code(i, j)
        mp = MatrixPtr()
        if which == M_MAT:
            mv = code & 3
            if mv == _NONE:
                return mp
            mp.matrix = (M_MAT, X_MAT, Y_MAT)[mv]
            mp.x_ind = i - 1
            mp.y_ind = j - 1
            mp.x_edge_ind = self.left.bwd[i][0]
            mp.y_edge_ind = self.right.bwd[j][0]
        elif which == X_MAT:
            mv = (code >> 2) & 3
            if mv == _NONE:
                mp.y_ind = j
                return mp
            mp.matrix = (X_MAT, Y_MAT, M_MAT)[mv]
            mp.x_ind = i - 1
            mp.y_ind = j
            mp.x_edge_ind = self.left.bwd[i][0]
        else:
            mv = (code >> 4) & 3
            if mv == _NONE:
                mp.x_ind = i
                return mp
            mp.matrix = (Y_MAT, X_MAT, M_MAT)[mv]
            mp.x_ind = i
            mp.y_ind = j - 1
            mp.y_edge_ind = self.right.bwd[j][0]
        return mp


def _pad_int(v, n, fill):
    out = np.full(n, fill, np.int32)
    out[:len(v)] = np.asarray(v, np.int32)
    return out


def banded_fill_args(left: SequenceGraph, right: SequenceGraph,
                     model: EvolModel, settings: AlignSettings,
                     upper, lower, dtype=np.float64):
    """Host prep for the windowed banded fill: returns (core, args,
    ilo) so callers (align path, bench) can invoke the jitted core
    directly."""
    inp = prepare_sheared(left, right, model, settings, dtype,
                          with_ms=False)
    L, R = inp["L"], inp["R"]
    ilo, Wreal = band_windows(upper, lower, L, R)
    W = _bucket(Wreal)
    D = L + R - 1
    # bucket every length-dependent dimension so the jitted core is
    # reused across pairs (bucket slop steps are masked no-ops)
    Db = _bucket(D)
    Lb = _bucket(L)

    Lpad = Lb + W + 1
    nf = model.log_score.shape[0]
    lstates = np.asarray(left.states[:L], np.int32)
    rstates = np.asarray(right.states[:R], np.int32)
    TL = np.zeros((Lpad, nf), dtype)
    TL[:L] = model.log_score[lstates].astype(dtype)

    def ext_row(vec, fill=0.0):
        v = np.full(Lpad, fill, dtype)
        v[:len(vec)] = vec
        return jnp.asarray(v)

    # reversed column vectors: rext[RextOff - (d-ilo) + t] == vec[(d-ilo)-t]
    pad_front = max(0, (D - 1) - (R - 1))
    off = pad_front + R - 1

    def rext(vec, np_dtype, fill):
        v = np.full(R, fill, np_dtype)
        v[:len(vec)] = vec
        out = np.full(_bucket(pad_front + R + W), fill, np_dtype)
        out[pad_front:pad_front + R] = v[::-1]
        return jnp.asarray(out)

    gj_rext = rext(inp["gext_j"], dtype, 0.0)
    orp_rext = rext(inp["open_r_shifted"], dtype, 0.0)
    rw_rext = rext(inp["rw"], dtype, 0.0)
    rs_rext = rext(rstates, np.int32, nf)  # out-of-range: no one-hot match

    open_l_prev = np.concatenate([[0.0], inp["open_l"][:-1]]).astype(dtype)

    # pad the diagonal schedule to the bucket; extra steps fall outside
    # [0, R) columns and are masked to no-ops in the core
    ilo_b = np.full(Db, ilo[-1] if len(ilo) else 0, np.int32)
    ilo_b[:len(ilo)] = ilo

    core = _get_banded_fill(W)
    args = (jnp.asarray(TL), rs_rext, gj_rext, orp_rext, rw_rext,
            ext_row(inp["gext_i"]), ext_row(open_l_prev),
            ext_row(inp["lw"]),
            jnp.asarray(_pad_int(upper[:L], Lpad, 0)),
            jnp.asarray(_pad_int(lower[:L], Lpad, R - 1)),
            jnp.asarray(ilo_b), dtype(inp["lng"]), dtype(inp["lgo"]),
            jnp.int32(L), jnp.int32(R), jnp.int32(off))
    return core, args, ilo, inp


def banded_align_path(left: SequenceGraph, right: SequenceGraph,
                      model: EvolModel, settings: AlignSettings,
                      upper, lower,
                      left_branch_length: float = 0.0,
                      right_branch_length: float = 0.0,
                      dtype=np.float64):
    """Banded fill with windowed memory + host backtrack. Falls back to
    the full masked kernel if the band cannot reach the end corner
    (viterbi_alignment.cpp:298-317).

    The fill is the windowed scan core below or, on a GPU, the Hopper
    kernel over the same window schedule (backend.fill_impl)."""
    from .viterbi_jax import _backtrack_arrays
    from .backend import fill_impl, count_fill, KERNEL

    L = left.num_sites() - 1
    R = right.num_sites() - 1
    if fill_impl("band") == KERNEL:
        from .hopper import linear_job, linear_fill, window_rows
        ilo, w = band_schedule(upper, lower, L, R)
        job = linear_job(left, right, model, settings, L, R,
                         band=(upper, lower))
        bp, final = linear_fill([job], L + R - 1, window_rows(w),
                                ilo=ilo)
        bp, final = bp[0], final[0]
        count_fill(KERNEL)
    else:
        core, args, ilo, _inp = banded_fill_args(
            left, right, model, settings, upper, lower, dtype)
        bp, final = core(*args)
        final = np.asarray(final)
        count_fill("scan")

    if not np.isfinite(final).any():
        from .viterbi_sheared import sheared_align_path
        return sheared_align_path(left, right, model, settings,
                                  left_branch_length, right_branch_length,
                                  dtype=dtype)

    cells = _BandedCells(bp, ilo, left, right)
    end = _end_corner_linear(final, left, right, model, L, R)
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, left, right, PathPtr(end, True), L, R,
                             left_branch_length, right_branch_length)
    return path, end
