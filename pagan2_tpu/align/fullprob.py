"""Device-side full-probability pass: forward/backward probability
planes, posterior, and stochastic path sampling for linear-chain graphs.

The reference computes forward probabilities inside the Viterbi fill
(Viterbi_alignment::compute_fwd_scores, viterbi_alignment.cpp:856-971 —
the `fwd_score +=` branches of the scoring kernels :2029-2255), then a
full-matrix backward pass + per-cell posterior full_score =
fwd*bwd/total (viterbi_alignment.cpp:329-371, 975-1034) and stochastic
backtracks drawing moves proportional to forward probability
(sample_new_path, :1193-1322).

Here both passes are sheared (diagonal-major) `lax.scan`s over the VPU:
one anti-diagonal of all three matrices per step, pure element-wise
ops. Because raw path probabilities underflow float32 after ~50 sites
(and float64 after ~300), every diagonal is rescaled by its max and the
log-scale accumulated separately — the classic scaled-HMM trick. The
stored planes are therefore (scaled value, cumulative log-scale) pairs;
`FullProbPlanes` exposes exact log-space accessors and posteriors
(posteriors are scale-free).

Semantics mirrored from the reference:
- forward gap moves use the plain extension probability and NO edge
  weights (viterbi_alignment.cpp:2151-2154 — the weighted versions are
  commented out); match moves DO fold in both edge weights (:2029-2112);
- the backward match term takes the match score at the *target* cell
  (score_match_bwd, :2259-2305);
- the bwd corner is seeded at the stop-sites' bwd-edge pair with
  non_gap * w_l * w_r (initialise_array_corner_bwd, :740-830);
- fwd/bwd totals must agree within 1% (:344-355) — checked here;
- terminal/reduced gap penalties do NOT enter the probability passes
  (only the Viterbi scores), matching the oracle.

Linear-chain pairs take the two-diagonal-lookback cores below; graph
pairs with bounded fan-in (454/homopolymer reads, ancestors with indel
edges) take the ring-of-diagonals cores in the fan-in section, so
--full-probability / --sample-path / posterior plots stay on device for
every realistic progressive run. Only beyond-cap graphs (fan-in > 8 or
edge offsets > 8) fall back to the host oracle in align_pair.
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
from .viterbi_sheared import _shear, _rext, _bucket

NEG = -np.inf


# ----------------------------------------------------------------------
# device scans
# ----------------------------------------------------------------------
def _fwd_core(msp_sh, wr_rext, wl, consts, Ldp, Rdp):
    """Forward probability fill in sheared layout.

    msp_sh (D, Lp): prob-space match scores on anti-diagonals;
    wr_rext: reversed/extended right edge weights so row d is one slice;
    wl (Lp,): left edge weights (match moves only);
    consts = [ext, gc*go, ng*go, ng*ng, gc*ng].
    Returns (fM, fX, fY) (D, Lp) scaled planes and fcum (D,) cumulative
    log-scales: true value = plane[d, i] * exp(fcum[d]).
    """
    D, Lp = msp_sh.shape
    Rp = wr_rext.shape[0] - 2 * Lp + 1
    f = msp_sh.dtype
    ext_p, gcgo, nggo, ng2, gcng = [consts[k] for k in range(5)]

    ii = jnp.arange(Lp)
    zero = jnp.zeros((Lp,), f)

    # d = 0: only M[0,0] = 1
    M0 = zero.at[0].set(1.0)
    P1 = (M0, zero, zero)          # planes at d-1 (unit scale exp(cum1))
    P2 = (zero, zero, zero)        # planes at d-2, pre-divided to cum1 units

    def shift(v):
        return jnp.concatenate([jnp.zeros((1,), f), v[:-1]])

    def step(carry, xs):
        (m1, x1, y1), (m2, x2, y2), cum = carry
        d, msp = xs
        start = Lp + Rp - 2 - d
        wr = lax.dynamic_slice_in_dim(wr_rext, start, Lp, axis=0)
        jj = d - ii
        valid = (jj >= 0) & (jj < Rdp) & (ii < Ldp)

        X = ext_p * shift(x1) + gcgo * shift(y1) + nggo * shift(m1)
        X = jnp.where(valid & (ii > 0), X, 0.0)
        Y = ext_p * y1 + gcgo * x1 + nggo * m1
        Y = jnp.where(valid & (jj > 0), Y, 0.0)
        M = msp * wl * wr * (ng2 * shift(m2) + gcng * shift(x2)
                             + gcng * shift(y2))
        M = jnp.where(valid & (ii > 0) & (jj > 0), M, 0.0)

        s = jnp.maximum(jnp.maximum(jnp.max(M), jnp.max(X)), jnp.max(Y))
        s = jnp.where(s > 0, s, jnp.array(1.0, f))
        inv = 1.0 / s
        out = (M * inv, X * inv, Y * inv)
        cum = cum + jnp.log(s)
        return (out, (m1 * inv, x1 * inv, y1 * inv), cum), (out, cum)

    ds = jnp.arange(1, D)
    _, ((Ms, Xs, Ys), cums) = lax.scan(
        step, (P1, P2, jnp.array(0.0, f)), (ds, msp_sh[1:]))
    fM = jnp.concatenate([M0[None], Ms], axis=0)
    fX = jnp.concatenate([zero[None], Xs], axis=0)
    fY = jnp.concatenate([zero[None], Ys], axis=0)
    fcum = jnp.concatenate([jnp.zeros((1,), f), cums])
    return fM, fX, fY, fcum


def _bwd_core(msp_sh, wr_rext, wl, consts, Ldp, Rdp, corner_seed):
    """Backward probability fill (compute_bwd_full_score,
    viterbi_alignment.cpp:975-1027) in sheared layout, reverse diagonal
    order. corner_seed = non_gap * w_lstop * w_rstop, injected at the
    corner cell's diagonal Ldp+Rdp-2 (NOT the padded top: with shape
    bucketing the grid extends beyond the real corner, and all padded
    diagonals above it are zero so the cumulative scale is still 0
    there).

    The match term needs bwd(M) at the *target* cell (i+1, j+1) times
    the target's match score and edge weights, so each emitted bM plane
    is pre-multiplied into a companion q = bM * msp * wl * wr plane
    rolled through the carry.
    Returns (bM, bX, bY) scaled planes and bcum (D,).
    """
    D, Lp = msp_sh.shape
    Rp = wr_rext.shape[0] - 2 * Lp + 1
    f = msp_sh.dtype
    ext_p, gcgo, nggo, ng2, gcng = [consts[k] for k in range(5)]

    ii = jnp.arange(Lp)
    zero = jnp.zeros((Lp,), f)
    corner_d = Ldp + Rdp - 2
    corner_lane = (ii == (Ldp - 1)).astype(f)

    def unshift(v):
        # lane i <- lane i+1 (successor row on the next diagonal)
        return jnp.concatenate([v[1:], jnp.zeros((1,), f)])

    def step(carry, xs):
        (m1, x1, y1, q1), q2, cum = carry
        d, msp = xs
        start = Lp + Rp - 2 - d
        wr = lax.dynamic_slice_in_dim(wr_rext, start, Lp, axis=0)
        jj = d - ii
        valid = (jj >= 0) & (jj < Rdp) & (ii < Ldp)

        xnb = unshift(x1)                  # bX at (i+1, j)
        ynb = y1                           # bY at (i, j+1)
        T = unshift(q2)                    # bM*ms*wl*wr at (i+1, j+1)

        X = ext_p * xnb + gcgo * ynb + gcng * T
        Y = ext_p * ynb + gcgo * xnb + gcng * T
        M = nggo * xnb + nggo * ynb + ng2 * T
        # corner seed (cum is exactly 0 above the corner diagonal)
        M = M + jnp.where(d == corner_d, corner_lane * corner_seed, 0.0)
        X = jnp.where(valid, X, 0.0)
        Y = jnp.where(valid, Y, 0.0)
        M = jnp.where(valid, M, 0.0)

        s = jnp.maximum(jnp.maximum(jnp.max(M), jnp.max(X)), jnp.max(Y))
        s = jnp.where(s > 0, s, jnp.array(1.0, f))
        inv = 1.0 / s
        M, X, Y = M * inv, X * inv, Y * inv
        q = M * msp * wl * wr
        cum = cum + jnp.log(s)
        return ((M, X, Y, q), q1 * inv, cum), ((M, X, Y), cum)

    ds = jnp.arange(D - 1, -1, -1)
    _, ((Ms, Xs, Ys), cums) = lax.scan(
        step, ((zero, zero, zero, zero), zero, jnp.array(0.0, f)),
        (ds, msp_sh[::-1]))
    # outputs are for d = D-1 .. 0; flip back to ascending
    return Ms[::-1], Xs[::-1], Ys[::-1], cums[::-1]


_fwd_fill = jax.jit(_fwd_core)
_bwd_fill = jax.jit(_bwd_core)
# batched variants: one launch fills a whole generation bucket's planes
# (every argument per-job, leading axis B)
_fwd_fill_batched = jax.jit(jax.vmap(_fwd_core))
_bwd_fill_batched = jax.jit(jax.vmap(_bwd_core))


def linear_plane_fills(msp_b, wr_b, wl_b, consts_b, Ldp_b, Rdp_b,
                       seeds_b):
    """Batched (B, ...) fwd+bwd plane fills: the vmapped scaled scans
    on every platform."""
    fwd = _fwd_fill_batched(msp_b, wr_b, wl_b, consts_b, Ldp_b, Rdp_b)
    bwd = _bwd_fill_batched(msp_b, wr_b, wl_b, consts_b, Ldp_b, Rdp_b,
                            seeds_b)
    return fwd, bwd


def linear_fullprob_inputs(left, right, model, dtype=np.float64,
                           Lp=None, Rp=None):
    """Host-side numpy inputs for the linear scaled scans — per-job and
    batch-stackable (pad every job of a bucket to the same Lp/Rp)."""
    from .viterbi_sheared import _shear_np, _rext_np
    L = left.num_sites() - 1
    R = right.num_sites() - 1
    Lp = Lp or _bucket(L)
    Rp = Rp or _bucket(R)
    D = Lp + Rp - 1
    m = model

    lstates = np.asarray(left.states[:L], np.int32)
    rstates = np.asarray(right.states[:R], np.int32)
    msp = np.zeros((Lp, Rp), dtype)
    msp[:L, :R] = m.score[np.ix_(lstates, rstates)].astype(dtype)
    msp_sh = np.ascontiguousarray(_shear_np(msp, D))

    def edge_w_vec(g, n, npad):
        """w[i] = raw weight of site i's bwd edge, vectorized (the
        per-site Python loop dominated host prep on many-leaf
        families, same hotspot as viterbi_sheared.edge_logw_vec)."""
        out = np.ones(npad, dtype)
        if n > 1:
            ids = np.fromiter((g.bwd[i][0] for i in range(1, n)),
                              np.int64, n - 1)
            out[1:n] = np.asarray(g.edges.weight,
                                  np.float64)[ids].astype(dtype)
        return out

    wl = edge_w_vec(left, L, Lp)
    wr = edge_w_vec(right, R, R)
    wr_rext = _rext_np(wr, R, Rp, Lp, dtype)

    w_lstop = float(left.edges.weight[left.bwd[L][0]])
    w_rstop = float(right.edges.weight[right.bwd[R][0]])
    consts = np.array(
        [m.ext_prob, m.gap_close() * m.gap_open(),
         m.non_gap() * m.gap_open(), m.non_gap() * m.non_gap(),
         m.gap_close() * m.non_gap()], dtype)
    return dict(L=L, R=R, Lp=Lp, Rp=Rp, msp_sh=msp_sh,
                wr_rext=wr_rext, wl=wl, consts=consts,
                w_lstop=w_lstop, w_rstop=w_rstop,
                seed=dtype(m.non_gap() * w_lstop * w_rstop))


# ----------------------------------------------------------------------
# host-side container
# ----------------------------------------------------------------------
class FullProbPlanes:
    """Scaled fwd/bwd probability planes for one pair.

    Planes are sheared (D, Lp): plane[d, i] holds cell (i, j=d-i) of one
    matrix, scaled so each diagonal's max is 1; true value =
    plane[d, i] * exp(cum[d]). Posteriors are computed scale-free.
    """

    def __init__(self, left, right, model, settings, dtype=np.float64,
                 fanin=None):
        self.left = left
        self.right = right
        self.model = model
        self.L = left.num_sites() - 1
        self.R = right.num_sites() - 1
        L, R = self.L, self.R
        Lp, Rp = _bucket(L), _bucket(R)
        self.Lp = Lp
        D = Lp + Rp - 1

        if fanin is None:
            # callers that already know the chain property pass it in
            # (is_linear_chain is an O(n) python scan per graph)
            from .viterbi_sheared import is_linear_chain
            fanin = not (is_linear_chain(left) and
                         is_linear_chain(right))
        self.fanin = fanin

        if not self.fanin:
            inp = linear_fullprob_inputs(left, right, model, dtype)
            self.w_lstop = inp["w_lstop"]
            self.w_rstop = inp["w_rstop"]
            args = (jnp.asarray(inp["msp_sh"][None]),
                    jnp.asarray(inp["wr_rext"][None]),
                    jnp.asarray(inp["wl"][None]),
                    jnp.asarray(inp["consts"][None]),
                    jnp.full((1,), L, jnp.int32),
                    jnp.full((1,), R, jnp.int32),
                    jnp.asarray(np.array([inp["seed"]])))
            (fM, fX, fY, fcum), (bM, bX, bY, bcum) = \
                linear_plane_fills(*args)
            fM, fX, fY, fcum = fM[0], fX[0], fY[0], fcum[0]
            bM, bX, bY, bcum = bM[0], bX[0], bY[0], bcum[0]
        else:
            fM, fX, fY, fcum, bM, bX, bY, bcum = self._run_fanin(dtype)

        self._finish((fM, fX, fY), fcum, (bM, bX, bY), bcum)

    @classmethod
    def from_arrays(cls, left, right, model, inp, f_planes, fcum,
                    b_planes, bcum, fanin=False):
        """Construct from pre-filled planes (the batched executor fills
        a whole generation bucket in one vmapped launch). inp is the
        job's linear_fullprob_inputs dict (fanin_fullprob_inputs when
        fanin=True)."""
        self = cls.__new__(cls)
        self.left = left
        self.right = right
        self.model = model
        self.L = inp["L"]
        self.R = inp["R"]
        self.Lp = inp["Lp"]
        self.fanin = fanin
        if not fanin:
            self.w_lstop = inp["w_lstop"]
            self.w_rstop = inp["w_rstop"]
        self._finish(f_planes, fcum, b_planes, bcum)
        return self

    def _finish(self, f_planes, fcum, b_planes, bcum):
        """Store planes + totals + the fwd/bwd 1% consistency check
        (viterbi_alignment.cpp:344-355)."""
        L, R = self.L, self.R
        m = self.model
        self.f = tuple(np.asarray(p) for p in f_planes)
        self.fcum = np.asarray(fcum)
        self.b = tuple(np.asarray(p) for p in b_planes)
        self.bcum = np.asarray(bcum)

        if not self.fanin:
            # fwd total at the end corner
            # (iterate_bwd_edges_for_end_corner's fwd accumulation,
            # viterbi_alignment.cpp:1440-1567): match via non_gap*wl*wr
            # + both gap closes via gap_close (no weights)
            gc = m.gap_close()
            d = L + R - 2
            i = L - 1
            tot = (m.non_gap() * self.w_lstop * self.w_rstop *
                   self._fp(M_MAT, d, i) +
                   gc * self._fp(X_MAT, d, i) +
                   gc * self._fp(Y_MAT, d, i))
            self.log_total = (np.log(tot) + self.fcum[d]) if tot > 0 \
                else NEG
        else:
            self.log_total = self._fanin_corner_total()
        bt = self._bp(M_MAT, 0, 0)
        self.log_total_bwd = (np.log(bt) + self.bcum[0]) if bt > 0 else NEG

        # fwd/bwd agreement within 1% (viterbi_alignment.cpp:344-355)
        from ..utils import log_out
        # the reference's window is a fixed 1% ratio on doubles; the
        # scaled scans accumulate one log per diagonal, so allow the
        # float-precision share of |log_total| on top (f32 runs on long
        # pairs drift ~1e-5 relative, far past where raw doubles would
        # have overflowed entirely)
        eps = np.finfo(self.fcum.dtype).eps
        tol = np.log(1.01) + 4 * eps * np.sqrt(max(len(self.fcum), 1)) \
            * abs(self.log_total)
        dlog = abs(self.log_total - self.log_total_bwd) \
            if np.isfinite(self.log_total_bwd) else np.inf
        if dlog > tol:
            log_out("Problem in computation? log fwd: %g, log bwd: %g"
                    % (self.log_total, self.log_total_bwd), 1)

    # -- fan-in graph path -------------------------------------------
    def _run_fanin(self, dtype):
        """Prep + device fills for one fan-in graph pair."""
        L, R = self.L, self.R
        inp = fanin_fullprob_inputs(self.left, self.right, self.model,
                                    dtype)
        KL, KR = inp["KL"], inp["KR"]
        OLm, ORm = inp["OLm"], inp["ORm"]
        F = max(8, ORm)
        roff_rext, rwp_rext = fanin_rext(inp["roffp"], inp["rwp"],
                                         inp["Lp"], inp["Rp"], F)

        if OLm <= 8 and ORm <= 8 and KL <= 8 and KR <= 8:
            # bounded offsets AND bounded fan-in (454/homopolymer):
            # one-hot cores (they compile KL*KR*OLm*ORm selects, so
            # deep fan-in routes to the gather cores below instead)
            fwd, bwd = _fanin_fills(KL, KR, OLm, ORm)
            args = (jnp.asarray(inp["msp_sh"]),
                    jnp.asarray(inp["loffp"]),
                    jnp.asarray(inp["lwp"]),
                    jnp.asarray(roff_rext), jnp.asarray(rwp_rext),
                    jnp.asarray(inp["consts"]),
                    jnp.int32(L), jnp.int32(R))
            fM, fX, fY, fcum = fwd(*args)
            bM, bX, bY, bcum = bwd(*args,
                                   jnp.asarray(inp["seed_block"]))
            return fM, fX, fY, fcum, bM, bX, bY, bcum

        # long bridges / deep fan-in: gather cores; the bwd pass
        # iterates FWD edges, streamed in the same layouts
        dev = jnp.asarray
        G = OLm + ORm
        rfoff_rext, rfw_rext = fanin_rext(inp["rfoff"], inp["rfw"],
                                          inp["Lp"], inp["Rp"], F)
        fwd, bwd = _fanin_gather_fills(KL, KR, inp["KFL"], inp["KFR"],
                                       G)
        msp_dev = dev(inp["msp_sh"])
        consts_dev = dev(inp["consts"])
        fM, fX, fY, fcum = fwd(
            msp_dev, dev(inp["loffp"]), dev(inp["lwp"]),
            dev(roff_rext), dev(rwp_rext), consts_dev,
            jnp.int32(L), jnp.int32(R))
        bM, bX, bY, bcum = bwd(
            msp_dev, dev(inp["lfoff"]), dev(inp["lfw"]),
            dev(rfoff_rext), dev(rfw_rext), consts_dev,
            jnp.int32(L), jnp.int32(R), dev(inp["seed_block"]))
        return fM, fX, fY, fcum, bM, bX, bY, bcum

    def _fanin_corner_total(self):
        """Forward total via the end-corner enumeration
        (viterbi_alignment.cpp:1440-1567). The reference re-visits the
        right gap-close per (le != le0, re != re0) pair, so those terms
        carry multiplicity len(lb); replicated for parity."""
        left, right, m = self.left, self.right, self.model
        L, R = self.L, self.R
        ng, gc = m.non_gap(), m.gap_close()
        lb = [(int(left.edges.start[e]), float(left.edges.weight[e]))
              for e in left.bwd[L]]
        rb = [(int(right.edges.start[e]), float(right.edges.weight[e]))
              for e in right.bwd[R]]
        terms = []   # (value in scaled units, log-scale)
        for li, wl in lb:
            for ri, wr in rb:
                d = li + ri
                terms.append((self._fp(M_MAT, d, li) * ng * wl * wr,
                              self.fcum[d]))
        for li, _wl in lb:
            d = li + R - 1
            terms.append((self._fp(X_MAT, d, li) * gc, self.fcum[d]))
        for n, (ri, _wr) in enumerate(rb):
            d = L - 1 + ri
            mult = 1 if n == 0 else len(lb)
            terms.append((mult * self._fp(Y_MAT, d, L - 1) * gc,
                          self.fcum[d]))
        mx = max((ls for v, ls in terms if v > 0), default=None)
        if mx is None:
            return NEG
        tot = sum(v * np.exp(ls - mx) for v, ls in terms if v > 0)
        return float(np.log(tot) + mx)

    # matrix-indexed scaled reads (mat in {X_MAT, Y_MAT, M_MAT};
    # planes are stored (M, X, Y))
    def _fp(self, mat, d, i):
        return float(self.f[{M_MAT: 0, X_MAT: 1, Y_MAT: 2}[mat]][d, i])

    def _bp(self, mat, d, i):
        return float(self.b[{M_MAT: 0, X_MAT: 1, Y_MAT: 2}[mat]][d, i])

    def fwd_scaled(self, mat, i, j):
        """(scaled value, log-scale) with true fwd = v * exp(ls)."""
        d = i + j
        return self._fp(mat, d, i), float(self.fcum[d])

    def fwd(self, mat, i, j):
        """Raw forward value. May over/underflow f64 on long pairs (the
        log-odds-scaled match scores exceed 1); only the scale-free
        posterior is consumed downstream, so that is acceptable."""
        v, ls = self.fwd_scaled(mat, i, j)
        with np.errstate(over="ignore", under="ignore"):
            return v * np.exp(ls)

    def bwd(self, mat, i, j):
        d = i + j
        with np.errstate(over="ignore", under="ignore"):
            return self._bp(mat, d, i) * np.exp(self.bcum[d])

    def posterior(self, mat, i, j):
        """full_score = fwd*bwd/total (viterbi_alignment.cpp:1029-1034),
        computed scale-free."""
        d = i + j
        k = {M_MAT: 0, X_MAT: 1, Y_MAT: 2}[mat]
        v = float(self.f[k][d, i]) * float(self.b[k][d, i])
        if v <= 0:
            return 0.0
        return v * np.exp(self.fcum[d] + self.bcum[d] - self.log_total)

    def posterior_plane(self):
        """(L-1, R-1) max-over-matrices posterior for the MetaPost
        heatmaps (plot_posterior_probabilities_*)."""
        L, R = self.L, self.R
        best = np.zeros((L, R))
        scale = self.fcum + self.bcum - self.log_total   # (D,)
        for k in range(3):
            prod = self.f[k] * self.b[k]                 # (D, Lp)
            with np.errstate(divide="ignore"):
                lp = np.where(prod > 0, np.log(prod), NEG) + scale[:, None]
            # unshear: cell (i, j) at plane[i+j, i]
            for i in range(L):
                row = lp[i:i + R, i]
                best[i] = np.maximum(best[i], np.exp(np.minimum(row, 0.0))
                                     * (row > NEG))
        return best[:L - 1, :R - 1]

    def total_fwd_score(self) -> float:
        with np.errstate(over="ignore", under="ignore"):
            return float(np.exp(self.log_total))


# ----------------------------------------------------------------------
# Viterbi path + posterior annotation
# ----------------------------------------------------------------------
def annotate_path(path, planes: FullProbPlanes, end: MatrixPtr):
    """Fill fwd/bwd/full_score on a Viterbi path's cells from the
    probability planes (the reference carries them in the DP cells;
    build_ancestral_sequence reads full_score as the site posterior,
    basic_alignment.cpp:61-179)."""
    end.fwd_score = planes.total_fwd_score()
    end.bwd_score = 1.0
    end.full_score = 1.0
    i, j = planes.L - 1, planes.R - 1
    mat = end.matrix
    for pp in reversed(path):
        mp = pp.mp
        if mp is end:
            # the end pointer keeps its sentinel scores (the oracle
            # never revisits it); it is not always path[-1] — trailing
            # pre-existing gaps follow it when the corner resolves
            # through a site-skipping stop edge
            continue
        if not pp.real_site:
            # pushed pre-existing gap: coordinates are explicit
            gi, gj = mp.x_ind, mp.y_ind
            mp.fwd_score = planes.fwd(mp.matrix, gi, gj)
            mp.bwd_score = planes.bwd(mp.matrix, gi, gj)
            mp.full_score = planes.posterior(mp.matrix, gi, gj)
            continue
        mp.fwd_score = planes.fwd(mat, i, j)
        mp.bwd_score = planes.bwd(mat, i, j)
        mp.full_score = planes.posterior(mat, i, j)
        # follow the stored predecessor coordinates (equal to plain
        # decrements on linear chains; graph edges may skip sites)
        if mat == M_MAT:
            i, j = mp.x_ind, mp.y_ind
        elif mat == X_MAT:
            i = mp.x_ind
        else:
            j = mp.y_ind
        mat = mp.matrix
    return path


def fullprob_viterbi_path(left, right, model, settings: AlignSettings,
                          left_branch_length=0.0, right_branch_length=0.0,
                          dtype=np.float64, band=None, planes=None,
                          linear=None):
    """Viterbi path via the sheared device kernel + posterior annotation
    from the probability planes. Returns (path, end, planes)."""
    from .viterbi_sheared import is_linear_chain, sheared_align_path
    if linear is None:
        linear = is_linear_chain(left) and is_linear_chain(right)
    if linear:
        path, end = sheared_align_path(left, right, model, settings,
                                       left_branch_length,
                                       right_branch_length,
                                       dtype=dtype, band=band)
    else:
        from .viterbi_fanin import fanin_align_path
        path, end = fanin_align_path(left, right, model, settings,
                                     left_branch_length,
                                     right_branch_length,
                                     dtype=dtype, band=band)
    if planes is None:
        planes = FullProbPlanes(left, right, model, settings, dtype,
                                fanin=not linear)
    annotate_path(path, planes, end)
    return path, end, planes


# ----------------------------------------------------------------------
# stochastic backtrack over the planes (sample_new_path,
# viterbi_alignment.cpp:1193-1322)
# ----------------------------------------------------------------------
def _draw(cands, rng):
    total = sum(c[0] for c in cands)
    r = total * rng.random()
    acc = 0.0
    for c in cands:
        acc += c[0]
        if acc >= r:
            return c
    return cands[-1]


def sample_path_planes(planes: FullProbPlanes, settings: AlignSettings,
                       rng, left_branch_length=0.0,
                       right_branch_length=0.0):
    """Draw one path proportional to forward probabilities
    (sample_new_path, viterbi_alignment.cpp:1193-1322). Linear chains
    take the fast single-diagonal candidate sets (per-diagonal scales
    cancel inside each draw); fan-in graphs enumerate per-edge
    candidates with explicit rescaling. Returns (path, end_ptr)."""
    if getattr(planes, "fanin", False):
        return _sample_fanin(planes, settings, rng,
                             left_branch_length, right_branch_length)
    left, right = planes.left, planes.right
    m = planes.model
    L, R = planes.L, planes.R
    gc, go, ng, ext = m.gap_close(), m.gap_open(), m.non_gap(), m.ext_prob

    def fs(mat, i, j):
        d = i + j
        return planes._fp(mat, d, i)

    # -- end corner (iterate_bwd_edges_for_sampled_end_corner) --------
    le0 = left.bwd[L][0]
    re0 = right.bwd[R][0]
    cands = [
        (fs(M_MAT, L - 1, R - 1) * ng * planes.w_lstop * planes.w_rstop,
         M_MAT, L - 1, R - 1, le0, re0),
        (fs(X_MAT, L - 1, R - 1) * gc * planes.w_lstop,
         X_MAT, L - 1, R - 1, le0, -1),
        (fs(Y_MAT, L - 1, R - 1) * gc * planes.w_rstop,
         Y_MAT, L - 1, R - 1, re0, -1),
    ]
    c = _draw(cands, rng)
    end = MatrixPtr(score=c[0], matrix=c[1], x_ind=c[2], y_ind=c[3])
    if c[1] == M_MAT:
        end.x_edge_ind, end.y_edge_ind = c[4], c[5]
    elif c[1] == X_MAT:
        end.x_edge_ind = c[4]
    else:
        end.y_edge_ind = c[4]
    end.bwd_score = 1.0
    end.full_score = 1.0
    end.fwd_score = planes.total_fwd_score()

    if end.x_edge_ind >= 0:
        left.edges.used[end.x_edge_ind] = True
    if end.y_edge_ind >= 0:
        right.edges.used[end.y_edge_ind] = True

    stack: list[PathPtr] = []
    vit_mat = end.matrix
    i, j = L - 1, R - 1
    if i > 0 or j > 0:
        stack.append(PathPtr(end, True))

    while True:
        if vit_mat == M_MAT:
            le = left.bwd[i][0]
            re = right.bwd[j][0]
            ms = m.score[left.states[i], right.states[j]]
            w = (float(left.edges.weight[le]) *
                 float(right.edges.weight[re]))
            li, rj = i - 1, j - 1
            cs = [(fs(M_MAT, li, rj) * ng * ng * ms * w, M_MAT),
                  (fs(X_MAT, li, rj) * gc * ng * ms * w, X_MAT),
                  (fs(Y_MAT, li, rj) * gc * ng * ms * w, Y_MAT)]
            pick = _draw(cs, rng)
            mp = MatrixPtr(score=pick[0], matrix=pick[1], x_ind=li,
                           y_ind=rj, x_edge_ind=le, y_edge_ind=re)
            mp.full_score = planes.posterior(M_MAT, i, j)
            left.edges.used[le] = True
            right.edges.used[re] = True
            vit_mat = pick[1]
            i -= 1
            j -= 1
        elif vit_mat == X_MAT:
            e = left.bwd[i][0]
            w = float(left.edges.weight[e])
            li = i - 1
            cs = [(fs(X_MAT, li, j) * ext * w, X_MAT),
                  (fs(Y_MAT, li, j) * gc * go * w, Y_MAT),
                  (fs(M_MAT, li, j) * ng * go * w, M_MAT)]
            pick = _draw(cs, rng)
            mp = MatrixPtr(score=pick[0], matrix=pick[1], x_ind=li,
                           y_ind=j, x_edge_ind=e)
            mp.full_score = planes.posterior(X_MAT, i, j)
            left.edges.used[e] = True
            vit_mat = pick[1]
            i -= 1
        else:
            e = right.bwd[j][0]
            w = float(right.edges.weight[e])
            rj = j - 1
            cs = [(fs(Y_MAT, i, rj) * ext * w, Y_MAT),
                  (fs(X_MAT, i, rj) * gc * go * w, X_MAT),
                  (fs(M_MAT, i, rj) * ng * go * w, M_MAT)]
            pick = _draw(cs, rng)
            mp = MatrixPtr(score=pick[0], matrix=pick[1], x_ind=i,
                           y_ind=rj, y_edge_ind=e)
            mp.full_score = planes.posterior(Y_MAT, i, j)
            right.edges.used[e] = True
            vit_mat = pick[1]
            j -= 1
        if i > 0 or j > 0:
            stack.append(PathPtr(mp, True))
        if i < 1 and j < 1:
            break

    return stack[::-1], end


# ----------------------------------------------------------------------
# fan-in graph cores: bounded per-site edge offsets (454/homopolymer
# reads, ancestors with indel edges). Same scaled sheared scans, but
# the two-diagonal lookback generalizes to a ring of the last G
# diagonals and per-slot one-hot offset selection, mirroring
# viterbi_fanin's Viterbi kernels in probability space:
# - forward gap moves SUM over bwd edges with NO edge weights
#   (oracle._score_gap_* fwd branches; viterbi_alignment.cpp:2151-2154);
# - forward match moves sum over edge pairs with both weights
#   (:2029-2112);
# - the backward pass iterates each cell's FWD edges, expressed here as
#   bwd-edge masks/weights of the *target* site shifted into the source
#   lane (compute_bwd_full_score, viterbi_alignment.cpp:975-1027);
# - bwd corner seeding covers every stop-site bwd-edge pair
#   (initialise_array_corner_bwd, :740-830), injected per diagonal from
#   a small host-built seed block.
# ----------------------------------------------------------------------
def fanin_fullprob_eligible(left, right) -> bool:
    """Device full-prob eligibility for graph pairs: always true.
    Bounded-offset, bounded-fan-in graphs (454/homopolymer) take the
    one-hot cores; everything else — long bridge edges, deep fan-in,
    wide fan-out — takes the gather cores, whose edge-slot count K and
    ring depth G are runtime shapes, not compile-time caps (the
    reference fwd/bwd runs on any graph, viterbi_alignment.cpp:329-371,
    2259-2305; the only remaining oracle use is engine="oracle")."""
    return True


def _shift_r(v, o):
    """Source lane i-o read at lane i (zeros roll in at the left)."""
    return jnp.concatenate([jnp.zeros((o,), v.dtype), v[:-o]])


def _shift_l(v, o):
    """Target lane i+o read at lane i (zeros roll in at the right)."""
    return jnp.concatenate([v[o:], jnp.zeros((o,), v.dtype)])


def _build_fwd_fanin(KL, KR, OLm, ORm):
    G = OLm + ORm

    def core(msp_sh, loffp, lwp, roff_rext, rwp_rext, consts, Ldp, Rdp):
        D, Lp = msp_sh.shape
        f = msp_sh.dtype
        ext_p, gcgo, nggo, ng2, gcng = [consts[k] for k in range(5)]
        ii = jnp.arange(Lp)
        zero = jnp.zeros((Lp,), f)
        Ext = roff_rext.shape[1]
        base = Ext - Lp - 2

        lmask = [[loffp[:, k] == o for o in range(1, OLm + 1)]
                 for k in range(KL)]
        lwk = [lwp[:, k] for k in range(KL)]

        M0 = zero.at[0].set(1.0)
        ring0 = jnp.zeros((G, Lp), f)

        def step(carry, xs):
            rM, rX, rY, cum = carry        # ring[g] = diag d-1-g, in
            d, msp = xs                    # units of cum (diag d-1)
            start = base - d
            roff = lax.dynamic_slice(roff_rext, (0, start), (KR, Lp))
            rwp = lax.dynamic_slice(rwp_rext, (0, start), (KR, Lp))
            jj = d - ii
            valid = (jj >= 0) & (jj < Rdp) & (ii < Ldp)

            gx = [ext_p * _shift_r(rX[o - 1], o)
                  + gcgo * _shift_r(rY[o - 1], o)
                  + nggo * _shift_r(rM[o - 1], o)
                  for o in range(1, OLm + 1)]
            X = zero
            for k in range(KL):
                acc = zero
                for o in range(1, OLm + 1):
                    acc = jnp.where(lmask[k][o - 1], gx[o - 1], acc)
                X = X + acc

            gy = [ext_p * rY[o - 1] + gcgo * rX[o - 1] + nggo * rM[o - 1]
                  for o in range(1, ORm + 1)]
            Y = zero
            for k in range(KR):
                acc = zero
                for o in range(1, ORm + 1):
                    acc = jnp.where(roff[k] == o, gy[o - 1], acc)
                Y = Y + acc

            gm = {}
            for s in range(1, OLm + 1):
                for r in range(1, ORm + 1):
                    g = s + r
                    gm[(s, r)] = (ng2 * _shift_r(rM[g - 1], s)
                                  + gcng * _shift_r(rX[g - 1], s)
                                  + gcng * _shift_r(rY[g - 1], s))
            Msum = zero
            for kl in range(KL):
                for kr in range(KR):
                    acc = zero
                    for s in range(1, OLm + 1):
                        for r in range(1, ORm + 1):
                            mm = lmask[kl][s - 1] & (roff[kr] == r)
                            acc = jnp.where(mm, gm[(s, r)], acc)
                    Msum = Msum + acc * lwk[kl] * rwp[kr]
            M = msp * Msum

            X = jnp.where(valid & (ii > 0), X, 0.0)
            Y = jnp.where(valid & (jj > 0), Y, 0.0)
            M = jnp.where(valid & (ii > 0) & (jj > 0), M, 0.0)

            sc = jnp.maximum(jnp.maximum(jnp.max(M), jnp.max(X)),
                             jnp.max(Y))
            sc = jnp.where(sc > 0, sc, jnp.array(1.0, f))
            inv = 1.0 / sc
            M, X, Y = M * inv, X * inv, Y * inv
            rM = jnp.concatenate([M[None], rM[:-1] * inv])
            rX = jnp.concatenate([X[None], rX[:-1] * inv])
            rY = jnp.concatenate([Y[None], rY[:-1] * inv])
            cum = cum + jnp.log(sc)
            return (rM, rX, rY, cum), ((M, X, Y), cum)

        ds = jnp.arange(1, D)
        carry0 = (ring0.at[0].set(M0), ring0, ring0, jnp.array(0.0, f))
        _, ((Ms, Xs, Ys), cums) = lax.scan(step, carry0,
                                           (ds, msp_sh[1:]))
        fM = jnp.concatenate([M0[None], Ms], axis=0)
        fX = jnp.concatenate([jnp.zeros((1, Lp), f), Xs], axis=0)
        fY = jnp.concatenate([jnp.zeros((1, Lp), f), Ys], axis=0)
        fcum = jnp.concatenate([jnp.zeros((1,), f), cums])
        return fM, fX, fY, fcum

    return core


def _build_bwd_fanin(KL, KR, OLm, ORm):
    G = OLm + ORm

    def core(msp_sh, loffp, lwp, roff_rext, rwp_rext, consts, Ldp, Rdp,
             seed_block):
        D, Lp = msp_sh.shape
        f = msp_sh.dtype
        ext_p, gcgo, nggo, ng2, gcng = [consts[k] for k in range(5)]
        ii = jnp.arange(Lp)
        zero = jnp.zeros((Lp,), f)
        Ext = roff_rext.shape[1]
        base = Ext - Lp - 2
        corner_d = Ldp + Rdp - 2
        Gs = seed_block.shape[0]

        # target-site masks/weights shifted into the source lane:
        # value[i] answers "does site i+o draw slot k from offset o"
        lmaskL = [[_shift_l((loffp[:, k] == o).astype(f), o) > 0
                   for o in range(1, OLm + 1)] for k in range(KL)]
        lwL = [[_shift_l(lwp[:, k], o) for o in range(1, OLm + 1)]
               for k in range(KL)]

        ring0 = jnp.zeros((G, Lp), f)

        def step(carry, xs):
            rq, rX, rY, cum = carry        # ring[g] = diag d+1+g
            d, msp = xs
            jj = d - ii
            valid = (jj >= 0) & (jj < Rdp) & (ii < Ldp)

            # right-side slices at diagonals d+1 .. d+ORm (value at
            # lane i = vec[(d+o) - i] = vec[j + o], the target site)
            roff_o = []
            rwp_o = []
            for o in range(1, ORm + 1):
                st = base - (d + o)
                roff_o.append(lax.dynamic_slice(roff_rext, (0, st),
                                                (KR, Lp)))
                rwp_o.append(lax.dynamic_slice(rwp_rext, (0, st),
                                               (KR, Lp)))

            # A: sum over left fwd edges of bX at (i+o, j) [no weights]
            xb = [_shift_l(rX[o - 1], o) for o in range(1, OLm + 1)]
            A = zero
            for k in range(KL):
                acc = zero
                for o in range(1, OLm + 1):
                    acc = jnp.where(lmaskL[k][o - 1], xb[o - 1], acc)
                A = A + acc
            # B: sum over right fwd edges of bY at (i, j+o)
            B = zero
            for k in range(KR):
                acc = zero
                for o in range(1, ORm + 1):
                    acc = jnp.where(roff_o[o - 1][k] == o, rY[o - 1],
                                    acc)
                B = B + acc
            # T: match term over fwd edge pairs: bM*ms at the target
            # cell (i+s, j+r) times both edge weights
            qsh = {}
            for s in range(1, OLm + 1):
                for r in range(1, ORm + 1):
                    if (s, s + r) not in qsh:
                        qsh[(s, s + r)] = _shift_l(rq[s + r - 1], s)
            T = zero
            for kl in range(KL):
                for kr in range(KR):
                    acc = zero
                    for s in range(1, OLm + 1):
                        for r in range(1, ORm + 1):
                            mm = lmaskL[kl][s - 1] & \
                                (roff_o[r - 1][kr] == r)
                            acc = jnp.where(
                                mm,
                                qsh[(s, s + r)] * lwL[kl][s - 1]
                                * rwp_o[r - 1][kr],
                                acc)
                    T = T + acc

            X = ext_p * A + gcgo * B + gcng * T
            Y = ext_p * B + gcgo * A + gcng * T
            M = nggo * A + nggo * B + ng2 * T

            idx = corner_d - d
            seed = jnp.where(
                (idx >= 0) & (idx < Gs),
                lax.dynamic_slice(seed_block,
                                  (jnp.clip(idx, 0, Gs - 1), 0),
                                  (1, Lp))[0],
                zero)
            # seeds are in true units; below the corner diagonal the
            # running scale is already nonzero, so convert (the clip
            # only guards exp overflow far past the seed window, where
            # the mask above zeroes the row anyway)
            clim = jnp.array(np.log(np.finfo(np.dtype(f).name).max) - 2.0, f)
            M = M + seed * jnp.exp(-jnp.clip(cum, -clim, clim))
            X = jnp.where(valid, X, 0.0)
            Y = jnp.where(valid, Y, 0.0)
            M = jnp.where(valid, M, 0.0)

            sc = jnp.maximum(jnp.maximum(jnp.max(M), jnp.max(X)),
                             jnp.max(Y))
            sc = jnp.where(sc > 0, sc, jnp.array(1.0, f))
            inv = 1.0 / sc
            M, X, Y = M * inv, X * inv, Y * inv
            q = M * msp
            rq = jnp.concatenate([q[None], rq[:-1] * inv])
            rX = jnp.concatenate([X[None], rX[:-1] * inv])
            rY = jnp.concatenate([Y[None], rY[:-1] * inv])
            cum = cum + jnp.log(sc)
            return (rq, rX, rY, cum), ((M, X, Y), cum)

        ds = jnp.arange(D - 1, -1, -1)
        carry0 = (ring0, ring0, ring0, jnp.array(0.0, f))
        _, ((Ms, Xs, Ys), cums) = lax.scan(step, carry0,
                                           (ds, msp_sh[::-1]))
        return Ms[::-1], Xs[::-1], Ys[::-1], cums[::-1]

    return core


_fanin_core_cache: dict = {}


def _fanin_fills(KL, KR, OLm, ORm):
    key = (KL, KR, OLm, ORm)
    if key not in _fanin_core_cache:
        _fanin_core_cache[key] = (
            jax.jit(_build_fwd_fanin(KL, KR, OLm, ORm)),
            jax.jit(_build_bwd_fanin(KL, KR, OLm, ORm)))
    return _fanin_core_cache[key]


def _sample_fanin(planes: FullProbPlanes, settings: AlignSettings, rng,
                  left_branch_length=0.0, right_branch_length=0.0):
    """Stochastic backtrack on fan-in graphs over the probability
    planes: per-edge candidate sets in the oracle's exact enumeration
    order (iterate_bwd_edges_for_sampled_{end_corner,match,gap},
    viterbi_alignment.cpp:1664-2028). Candidates source different
    diagonals, so each draw rescales by the max diagonal log-scale
    (ratios equal the oracle's raw-probability ratios)."""
    left, right, m = planes.left, planes.right, planes.model
    L, R = planes.L, planes.R
    ng, gc, go, ext = m.non_gap(), m.gap_close(), m.gap_open(), m.ext_prob
    lw = left.edges.weight
    rw = right.edges.weight
    lstart = left.edges.start
    rstart = right.edges.start

    def fsc(mat, i, j):
        d = i + j
        return planes._fp(mat, d, i), float(planes.fcum[d])

    def draw(cands):
        mx = max((ls for v, ls, _ in cands if v > 0), default=0.0)
        vals = [v * np.exp(ls - mx) if v > 0 else 0.0
                for v, ls, _ in cands]
        total = sum(vals)
        r = total * rng.random()
        acc = 0.0
        for v, (_, _, mp) in zip(vals, cands):
            acc += v
            if acc >= r:
                return mp
        return cands[-1][2]

    # -- end corner (iterate_bwd_edges_for_sampled_end_corner) --------
    lb = left.bwd[L]
    rb = right.bwd[R]
    cands = []

    def add_m(le, re):
        li, ri = int(lstart[le]), int(rstart[re])
        v, ls = fsc(M_MAT, li, ri)
        mp = MatrixPtr(matrix=M_MAT, x_ind=li, y_ind=ri,
                       x_edge_ind=le, y_edge_ind=re)
        cands.append((v * ng * float(lw[le]) * float(rw[re]), ls, mp))

    def add_close(e, is_x):
        if is_x:
            prev = int(lstart[e])
            v, ls = fsc(X_MAT, prev, R - 1)
            mp = MatrixPtr(matrix=X_MAT, x_ind=prev, y_ind=R - 1,
                           x_edge_ind=e)
            cands.append((v * gc * float(lw[e]), ls, mp))
        else:
            prev = int(rstart[e])
            v, ls = fsc(Y_MAT, L - 1, prev)
            mp = MatrixPtr(matrix=Y_MAT, x_ind=L - 1, y_ind=prev,
                           y_edge_ind=e)
            cands.append((v * gc * float(rw[e]), ls, mp))

    le0, re0 = lb[0], rb[0]
    add_m(le0, re0)
    add_close(le0, True)
    add_close(re0, False)
    for re in rb[1:]:
        add_m(le0, re)
        add_close(re, False)
    for le in lb[1:]:
        add_m(le, re0)
        add_close(le, True)
        for re in rb[1:]:
            add_m(le, re)
            add_close(re, False)
    end = draw(cands).copy()
    end.bwd_score = 1.0
    end.full_score = 1.0
    end.fwd_score = planes.total_fwd_score()
    if end.x_edge_ind >= 0:
        left.edges.used[end.x_edge_ind] = True
    if end.y_edge_ind >= 0:
        right.edges.used[end.y_edge_ind] = True

    # -- per-cell samplers --------------------------------------------
    def sampled_match(i, j):
        ms = float(m.score[left.states[i], right.states[j]])
        m_match = ng * ng * ms
        z_match = gc * ng * ms
        cs = []

        def add(le, re):
            li, ri = int(lstart[le]), int(rstart[re])
            w = float(lw[le]) * float(rw[re])
            for mat_id, fac in ((M_MAT, m_match), (X_MAT, z_match),
                                (Y_MAT, z_match)):
                v, ls = fsc(mat_id, li, ri)
                mp = MatrixPtr(matrix=mat_id, x_ind=li, y_ind=ri,
                               x_edge_ind=le, y_edge_ind=re)
                cs.append((v * fac * w, ls, mp))

        lbi = left.bwd[i]
        rbj = right.bwd[j]
        e0, f0 = lbi[0], rbj[0]
        add(e0, f0)
        for re in rbj[1:]:
            add(e0, re)
        for le in lbi[1:]:
            add(le, f0)
            for re in rbj[1:]:
                add(le, re)
        sp = draw(cs).copy()
        sp.fwd_score = planes.fwd(M_MAT, i, j)
        sp.bwd_score = planes.bwd(M_MAT, i, j)
        sp.full_score = planes.posterior(M_MAT, i, j)
        return sp

    def sampled_gap(i, j, is_x):
        cs = []
        if is_x:
            seq, w, site = left, lw, i
            zmat, wmat = X_MAT, Y_MAT
        else:
            seq, w, site = right, rw, j
            zmat, wmat = Y_MAT, X_MAT
        for e in seq.bwd[site]:
            prev = int(seq.edges.start[e])
            we = float(w[e])

            def mk(v, ls, mat_id):
                mp = MatrixPtr(matrix=mat_id)
                if is_x:
                    mp.x_ind = prev
                    mp.x_edge_ind = e
                else:
                    mp.y_ind = prev
                    mp.y_edge_ind = e
                cs.append((v, ls, mp))

            if is_x:
                vz, lz = fsc(X_MAT, prev, j)
                vw, lwv = fsc(Y_MAT, prev, j)
                vm, lm = fsc(M_MAT, prev, j)
            else:
                vz, lz = fsc(Y_MAT, i, prev)
                vw, lwv = fsc(X_MAT, i, prev)
                vm, lm = fsc(M_MAT, i, prev)
            mk(vz * ext * we, lz, zmat)
            mk(vw * gc * go * we, lwv, wmat)
            mk(vm * ng * go * we, lm, M_MAT)
        sp = draw(cs).copy()
        which = X_MAT if is_x else Y_MAT
        sp.fwd_score = planes.fwd(which, i, j)
        sp.bwd_score = planes.bwd(which, i, j)
        sp.full_score = planes.posterior(which, i, j)
        if is_x:
            sp.y_ind = j
        else:
            sp.x_ind = i
        return sp

    # -- walk (sample_new_path, viterbi_alignment.cpp:1193-1322) ------
    stack: list[PathPtr] = []
    ij = [L - 1, R - 1]
    vit_mat = end.matrix

    def push_gap(i, j, matrix, bl):
        mp = MatrixPtr(score=-1, x_ind=i, y_ind=j, matrix=matrix)
        mp.fwd_score = planes.fwd(matrix, i, j)
        mp.bwd_score = planes.bwd(matrix, i, j)
        mp.full_score = planes.posterior(matrix, i, j)
        stack.append(PathPtr(mp, False, bl, 1))

    def insert_preexisting_gap(x_ind, y_ind):
        while x_ind < ij[0]:
            push_gap(ij[0] - 1, ij[1], X_MAT, left_branch_length)
            ij[0] -= 1
        while y_ind < ij[1]:
            push_gap(ij[0], ij[1] - 1, Y_MAT, right_branch_length)
            ij[1] -= 1

    def insert_pp(pp):
        if ij[0] > 0 or ij[1] > 0:
            stack.append(pp)

    insert_preexisting_gap(end.x_ind, end.y_ind)
    insert_pp(PathPtr(end, True))

    while True:
        i, j = ij
        if vit_mat == M_MAT:
            bwd_p = sampled_match(i, j)
            left.edges.used[bwd_p.x_edge_ind] = True
            right.edges.used[bwd_p.y_edge_ind] = True
            ij[0] -= 1
            ij[1] -= 1
        elif vit_mat == X_MAT:
            bwd_p = sampled_gap(i, j, True)
            left.edges.used[bwd_p.x_edge_ind] = True
            ij[0] -= 1
        else:
            bwd_p = sampled_gap(i, j, False)
            right.edges.used[bwd_p.y_edge_ind] = True
            ij[1] -= 1
        vit_mat = bwd_p.matrix
        insert_preexisting_gap(bwd_p.x_ind, bwd_p.y_ind)
        insert_pp(PathPtr(bwd_p, True))
        if ij[0] < 1 and ij[1] < 1:
            break

    return stack[::-1], end


# ----------------------------------------------------------------------
# gather-based fan-in cores: arbitrary edge offsets up to the ring cap.
# The one-hot cores above compile KL*KR*OLm*ORm selects, which is fine
# for 454/homopolymer offsets (<= 8) but explodes for ancestors whose
# indel bridges skip dozens of sites. Probability passes only SUM edge
# contributions (no first-wins codes), so a handful of flat-ring
# gathers replaces the selection entirely; ring depth G is the only
# static shape.
# ----------------------------------------------------------------------
def fanout_arrays(g, n, dtype=np.float64):
    """Per-site FWD-edge offset/weight arrays over sites 0..n-1,
    excluding edges into the stop site (the oracle's bwd pass skips
    nxt >= L; stop-edge mass arrives via the corner seeds)."""
    KF = 1
    offs = []
    for i in range(n):
        row = [(int(g.edges.end[e]) - i, float(g.edges.weight[e]))
               for e in g.fwd[i] if int(g.edges.end[e]) < n]
        offs.append(row)
        KF = max(KF, len(row))
    off = np.zeros((n, KF), np.int32)
    w = np.zeros((n, KF), dtype)
    for i, row in enumerate(offs):
        for k, (o, wt) in enumerate(row):
            off[i, k] = o
            w[i, k] = wt
    return off, w


def fanin_fullprob_inputs(left, right, model, dtype=np.float64,
                          Lp=None, Rp=None):
    """Host-side numpy inputs for the fan-in probability cores — per-job
    and batch-stackable. K-slot axes (KL/KR/KFL/KFR), the seed depth and
    the ring G pad with inert zero slots, so a batch bucket stacks jobs
    at the bucket maxima; the reversed right-side layouts are built
    separately with `fanin_rext` at a shared F."""
    from .viterbi_sheared import _shear_np
    L = left.num_sites() - 1
    R = right.num_sites() - 1
    Lp = Lp or _bucket(L)
    Rp = Rp or _bucket(R)
    D = Lp + Rp - 1
    m = model

    lstates = np.asarray(left.states[:L], np.int32)
    rstates = np.asarray(right.states[:R], np.int32)
    msp = np.zeros((Lp, Rp), dtype)
    msp[:L, :R] = m.score[np.ix_(lstates, rstates)].astype(dtype)
    msp_sh = np.ascontiguousarray(_shear_np(msp, D))
    consts = np.array(
        [m.ext_prob, m.gap_close() * m.gap_open(),
         m.non_gap() * m.gap_open(), m.non_gap() * m.non_gap(),
         m.gap_close() * m.non_gap()], dtype)

    la = left.padded_bwd_arrays()
    ra = right.padded_bwd_arrays()

    def side(arr, n, Np):
        ar = np.arange(n)[:, None]
        mask = arr["mask"][:n] & (arr["prev"][:n] >= 0) & \
            (arr["prev"][:n] < ar)
        offp = np.zeros((Np, arr["prev"].shape[1]), np.int32)
        wp = np.zeros((Np, arr["prev"].shape[1]), dtype)
        offp[:n] = np.where(mask, ar - arr["prev"][:n], 0)
        wp[:n] = np.where(mask, arr["w"][:n], 0.0)
        return offp, wp

    loffp, lwp = side(la, L, Lp)
    roffp, rwp = side(ra, R, R)
    OLm = max(1, int(loffp.max()))
    ORm = max(1, int(roffp.max()))

    # fwd-edge (bwd-pass) arrays
    lfoff_r, lfw_r = fanout_arrays(left, L, dtype)
    rfoff_r, rfw_r = fanout_arrays(right, R, dtype)
    lfoff = np.zeros((Lp, lfoff_r.shape[1]), np.int32)
    lfw = np.zeros((Lp, lfw_r.shape[1]), dtype)
    lfoff[:L] = lfoff_r
    lfw[:L] = lfw_r

    # bwd corner seeds over every stop-site bwd-edge pair
    # (initialise_array_corner_bwd, viterbi_alignment.cpp:740-830)
    lb = [(int(left.edges.start[e]), float(left.edges.weight[e]))
          for e in left.bwd[L]]
    rb = [(int(right.edges.start[e]), float(right.edges.weight[e]))
          for e in right.bwd[R]]
    corner_d = L + R - 2
    Gs = 1
    for li, _ in lb:
        for ri, _ in rb:
            Gs = max(Gs, corner_d - (li + ri) + 1)
    seed_block = np.zeros((Gs, Lp), dtype)
    seed_block[0, L - 1] = m.non_gap()
    for li, wl in lb:
        for ri, wr in rb:
            seed_block[corner_d - (li + ri), li] = \
                m.non_gap() * wl * wr

    return dict(L=L, R=R, Lp=Lp, Rp=Rp, msp_sh=msp_sh, consts=consts,
                loffp=loffp, lwp=lwp, roffp=roffp, rwp=rwp,
                lfoff=lfoff, lfw=lfw, rfoff=rfoff_r, rfw=rfw_r,
                seed_block=seed_block,
                KL=loffp.shape[1], KR=roffp.shape[1],
                KFL=lfoff.shape[1], KFR=rfoff_r.shape[1],
                OLm=OLm, ORm=ORm)


def fanin_rext(arrT_off, arrT_w, Lp, Rp, F):
    """Reversed extended right-side layouts: value at
    slice(base - d)[i] is the column vector at j = d - i; the front
    padding F absorbs the d+ORm lookahead of the bwd pass. A batch
    bucket passes the SAME F for every job so the slices line up."""
    R = arrT_off.shape[0]
    K = arrT_off.shape[1]
    Ext = F + 2 * Lp + Rp
    off_rext = np.zeros((K, Ext), np.int32)
    w_rext = np.zeros((K, Ext), arrT_w.dtype)
    pos = F + Lp + Rp - 2 - np.arange(R)
    off_rext[:, pos] = arrT_off.T
    w_rext[:, pos] = arrT_w.T
    return off_rext, w_rext


_fanin_gather_batched_cache: dict = {}


def fanin_gather_fills_batched(KL, KR, KFL, KFR, G):
    """Vmapped gather-core fills for a batch bucket of fan-in
    full-probability jobs (the task-parallel form of
    viterbi_alignment.cpp:329-371 at node.cpp:227-269's intent)."""
    key = (KL, KR, KFL, KFR, G)
    if key not in _fanin_gather_batched_cache:
        _fanin_gather_batched_cache[key] = (
            jax.jit(jax.vmap(_build_fwd_fanin_gather(KL, KR, G))),
            jax.jit(jax.vmap(_build_bwd_fanin_gather(KFL, KFR, G))))
    return _fanin_gather_batched_cache[key]


def _build_fwd_fanin_gather(KL, KR, G):
    def core(msp_sh, loffp, lwp, roff_rext, rwp_rext, consts, Ldp, Rdp):
        D, Lp = msp_sh.shape
        f = msp_sh.dtype
        ext_p, gcgo, nggo, ng2, gcng = [consts[k] for k in range(5)]
        lane = jnp.arange(Lp)
        zero = jnp.zeros((Lp,), f)
        Ext = roff_rext.shape[1]
        base = Ext - Lp - 2

        oL = loffp.T.astype(jnp.int32)          # (KL, Lp)
        lwT = lwp.T
        M0 = zero.at[0].set(1.0)
        ring0 = jnp.zeros((G * Lp,), f)

        idxL = (oL - 1) * Lp + lane[None, :] - oL
        okL = (oL > 0) & (oL <= G) & (lane[None, :] - oL >= 0)
        idxLc = jnp.clip(idxL, 0, G * Lp - 1)

        def step(carry, xs):
            rM, rX, rY, cum = carry             # flat (G*Lp,) rings
            d, msp = xs
            start = base - d
            roff = lax.dynamic_slice(roff_rext, (0, start), (KR, Lp))
            rwp = lax.dynamic_slice(rwp_rext, (0, start), (KR, Lp))
            jj = d - lane
            valid = (jj >= 0) & (jj < Rdp) & (lane < Ldp)

            # X: sum over left bwd edges, no weights
            # (oracle._score_gap_* fwd branches)
            comboX = (ext_p * jnp.take(rX, idxLc)
                      + gcgo * jnp.take(rY, idxLc)
                      + nggo * jnp.take(rM, idxLc))
            X = jnp.sum(jnp.where(okL, comboX, 0.0), axis=0)

            oR = roff
            idxR = jnp.clip((oR - 1) * Lp + lane[None, :], 0,
                            G * Lp - 1)
            okR = (oR > 0) & (oR <= G)
            comboY = (ext_p * jnp.take(rY, idxR)
                      + gcgo * jnp.take(rX, idxR)
                      + nggo * jnp.take(rM, idxR))
            Y = jnp.sum(jnp.where(okR, comboY, 0.0), axis=0)

            # M: edge pairs, both weights (oracle._score_match)
            ot = oL[:, None, :] + oR[None, :, :]
            idxM = jnp.clip((ot - 1) * Lp + lane[None, None, :]
                            - oL[:, None, :], 0, G * Lp - 1)
            okM = (oL[:, None, :] > 0) & (oR[None, :, :] > 0) & \
                (ot <= G) & (lane[None, None, :] - oL[:, None, :] >= 0)
            comboM = (ng2 * jnp.take(rM, idxM)
                      + gcng * jnp.take(rX, idxM)
                      + gcng * jnp.take(rY, idxM))
            contrib = comboM * lwT[:, None, :] * rwp[None, :, :]
            M = msp * jnp.sum(jnp.where(okM, contrib, 0.0),
                              axis=(0, 1))

            X = jnp.where(valid & (lane > 0), X, 0.0)
            Y = jnp.where(valid & (jj > 0), Y, 0.0)
            M = jnp.where(valid & (lane > 0) & (jj > 0), M, 0.0)

            sc = jnp.maximum(jnp.maximum(jnp.max(M), jnp.max(X)),
                             jnp.max(Y))
            sc = jnp.where(sc > 0, sc, jnp.array(1.0, f))
            inv = 1.0 / sc
            M, X, Y = M * inv, X * inv, Y * inv
            rM = jnp.concatenate([M, rM[:-Lp] * inv])
            rX = jnp.concatenate([X, rX[:-Lp] * inv])
            rY = jnp.concatenate([Y, rY[:-Lp] * inv])
            cum = cum + jnp.log(sc)
            return (rM, rX, rY, cum), ((M, X, Y), cum)

        ds = jnp.arange(1, D)
        carry0 = (jnp.concatenate([M0, jnp.zeros(((G - 1) * Lp,), f)]),
                  ring0, ring0, jnp.array(0.0, f))
        _, ((Ms, Xs, Ys), cums) = lax.scan(step, carry0,
                                           (ds, msp_sh[1:]))
        fM = jnp.concatenate([M0[None], Ms], axis=0)
        fX = jnp.concatenate([jnp.zeros((1, Lp), f), Xs], axis=0)
        fY = jnp.concatenate([jnp.zeros((1, Lp), f), Ys], axis=0)
        fcum = jnp.concatenate([jnp.zeros((1,), f), cums])
        return fM, fX, fY, fcum

    return core


def _build_bwd_fanin_gather(KFL, KFR, G):
    def core(msp_sh, lfoff, lfw, rfoff_rext, rfw_rext, consts, Ldp,
             Rdp, seed_block):
        D, Lp = msp_sh.shape
        f = msp_sh.dtype
        ext_p, gcgo, nggo, ng2, gcng = [consts[k] for k in range(5)]
        lane = jnp.arange(Lp)
        zero = jnp.zeros((Lp,), f)
        Ext = rfoff_rext.shape[1]
        base = Ext - Lp - 2
        corner_d = Ldp + Rdp - 2
        Gs = seed_block.shape[0]
        clim = jnp.array(np.log(np.finfo(np.dtype(f).name).max) - 2.0, f)

        oL = lfoff.T.astype(jnp.int32)           # (KFL, Lp)
        lwT = lfw.T
        ring0 = jnp.zeros((G * Lp,), f)

        idxL = (oL - 1) * Lp + lane[None, :] + oL
        okL = (oL > 0) & (oL <= G) & (lane[None, :] + oL < Lp)
        idxLc = jnp.clip(idxL, 0, G * Lp - 1)

        def step(carry, xs):
            rq, rX, rY, cum = carry              # ring[g] = diag d+1+g
            d, msp = xs
            start = base - d
            rfoff = lax.dynamic_slice(rfoff_rext, (0, start), (KFR, Lp))
            rfw = lax.dynamic_slice(rfw_rext, (0, start), (KFR, Lp))
            jj = d - lane
            valid = (jj >= 0) & (jj < Rdp) & (lane < Ldp)

            # A: bX at (i+o, j) over left fwd edges (no weights)
            A = jnp.sum(jnp.where(okL, jnp.take(rX, idxLc), 0.0),
                        axis=0)
            # B: bY at (i, j+o) over right fwd edges
            oR = rfoff
            idxR = jnp.clip((oR - 1) * Lp + lane[None, :], 0,
                            G * Lp - 1)
            okR = (oR > 0) & (oR <= G)
            B = jnp.sum(jnp.where(okR, jnp.take(rY, idxR), 0.0),
                        axis=0)
            # T: bM*ms at the target cell (i+s, j+r), both edge weights
            ot = oL[:, None, :] + oR[None, :, :]
            idxM = jnp.clip((ot - 1) * Lp + lane[None, None, :]
                            + oL[:, None, :], 0, G * Lp - 1)
            okM = (oL[:, None, :] > 0) & (oR[None, :, :] > 0) & \
                (ot <= G) & \
                (lane[None, None, :] + oL[:, None, :] < Lp)
            contrib = jnp.take(rq, idxM) * lwT[:, None, :] \
                * rfw[None, :, :]
            T = jnp.sum(jnp.where(okM, contrib, 0.0), axis=(0, 1))

            X = ext_p * A + gcgo * B + gcng * T
            Y = ext_p * B + gcgo * A + gcng * T
            M = nggo * A + nggo * B + ng2 * T

            idx = corner_d - d
            seed = jnp.where(
                (idx >= 0) & (idx < Gs),
                lax.dynamic_slice(seed_block,
                                  (jnp.clip(idx, 0, Gs - 1), 0),
                                  (1, Lp))[0],
                zero)
            M = M + seed * jnp.exp(-jnp.clip(cum, -clim, clim))
            X = jnp.where(valid, X, 0.0)
            Y = jnp.where(valid, Y, 0.0)
            M = jnp.where(valid, M, 0.0)

            sc = jnp.maximum(jnp.maximum(jnp.max(M), jnp.max(X)),
                             jnp.max(Y))
            sc = jnp.where(sc > 0, sc, jnp.array(1.0, f))
            inv = 1.0 / sc
            M, X, Y = M * inv, X * inv, Y * inv
            q = M * msp
            rq = jnp.concatenate([q, rq[:-Lp] * inv])
            rX = jnp.concatenate([X, rX[:-Lp] * inv])
            rY = jnp.concatenate([Y, rY[:-Lp] * inv])
            cum = cum + jnp.log(sc)
            return (rq, rX, rY, cum), ((M, X, Y), cum)

        ds = jnp.arange(D - 1, -1, -1)
        carry0 = (ring0, ring0, ring0, jnp.array(0.0, f))
        _, ((Ms, Xs, Ys), cums) = lax.scan(step, carry0,
                                           (ds, msp_sh[::-1]))
        return Ms[::-1], Xs[::-1], Ys[::-1], cums[::-1]

    return core


_fanin_gather_cache: dict = {}


def _fanin_gather_fills(KL, KR, KFL, KFR, G):
    key = (KL, KR, KFL, KFR, G)
    if key not in _fanin_gather_cache:
        _fanin_gather_cache[key] = (
            jax.jit(_build_fwd_fanin_gather(KL, KR, G)),
            jax.jit(_build_bwd_fanin_gather(KFL, KFR, G)))
    return _fanin_gather_cache[key]
