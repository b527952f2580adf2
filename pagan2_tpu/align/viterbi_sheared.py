"""Sheared (diagonal-major) wavefront DP for linear-chain graphs.

When both input graphs are plain chains (every site has exactly one
back-edge to its predecessor — true for all leaf sequences outside
454/homopolymer mode and for most ancestors), the graph DP collapses to
a classic 3-state affine recurrence. This kernel stores diagonals as
vectors ("shearing" the DP plane) so one `lax.scan` step updates a whole
anti-diagonal with pure element-wise ops — no gathers in the loop.
Backpointers pack into one int8 per cell (2 bits per matrix).

Candidate evaluation order matches the reference exactly
(viterbi_alignment.cpp:1328-1436: gap = ext, double, open; match =
m, x, y; strict-greater first-wins), so tracebacks are identical to the
host oracle for chain inputs.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..graph.sequence_graph import SequenceGraph
from ..models.evol_model import EvolModel
from .settings import AlignSettings, X_MAT, Y_MAT, M_MAT
from .oracle import MatrixPtr, PathPtr, first_is_bigger

NEG = -np.inf
_NONE = 3  # "no backpointer" 2-bit code


def is_linear_chain(g: SequenceGraph) -> bool:
    """Fast-path eligibility: every site 1..N-1 has exactly one bwd edge,
    from its immediate predecessor."""
    for i in range(1, g.num_sites()):
        b = g.bwd[i]
        if len(b) != 1 or g.edges.start[b[0]] != i - 1:
            return False
    return True


# ----------------------------------------------------------------------
def batched_sheared_core(ms_sh, gj_rext, orp_rext, rw_rext, gext_i, open_l,
                         lw, lng, lgo, Ldp, Rdp, band_lo, band_hi):
    """Batch-native fill in sheared layout (no vmap: a hand-batched scan
    keeps the loop body a handful of large element-wise ops).

    ms_sh is (B, D, Lp): anti-diagonal rows of the match-score tables.
    gj_rext/orp_rext/rw_rext are column-indexed vectors (gap-ext by j,
    open penalty by j-1, right edge log-weight by j) pre-REVERSED and
    zero-padded to length 2*Lp+Rp-1, so the diagonal-d row is one
    dynamic_slice (HBM stays O(D) per vector, no per-step flip).
    gext_i/open_l/lw are (B, Lp); lng/lgo/Ldp/Rdp are (B,).
    band_lo/band_hi (B, Lp) int32 restrict each row's column range — the
    anchored tunnel (full matrix: 0 / Rp-1). Out-of-band cells stay at
    -inf, reproducing the Tunnel_matrix sentinel semantics
    (tunnel_matrix.h:82-98).
    Returns (bp (B, D, Lp) int8, final (B, 3) corner-cell scores).
    """
    B, D, Lp = ms_sh.shape
    Rp = gj_rext.shape[1] - 2 * Lp + 1
    f = ms_sh.dtype
    big_neg = jnp.array(NEG, f)

    ii = jnp.arange(Lp)[None, :]                    # (1, Lp)
    lngb = lng[:, None]
    lgob = lgo[:, None]
    Ldpb = Ldp[:, None]
    Rdpb = Rdp[:, None]

    M1 = jnp.full((B, Lp), big_neg, f).at[:, 0].set(0.0)
    X1 = jnp.full((B, Lp), big_neg, f)
    Y1 = jnp.full((B, Lp), big_neg, f)
    M2 = jnp.full((B, Lp), big_neg, f)
    X2 = jnp.full((B, Lp), big_neg, f)
    Y2 = jnp.full((B, Lp), big_neg, f)
    final = jnp.full((B, 3), big_neg, f)

    open_l_prev = jnp.concatenate(
        [jnp.zeros((B, 1), f), open_l[:, :-1]], axis=1)
    corner_onehot = (ii == Ldpb - 1).astype(f)      # (B, Lp)

    def shift(v):
        # element i <- element i-1 (predecessor row on previous diagonal)
        return jnp.concatenate(
            [jnp.full((B, 1), big_neg, f), v[:, :-1]], axis=1)

    def step(carry, xs):
        M1, X1, Y1, M2, X2, Y2, final = carry
        d, ms = xs
        # row[i] = vec[d-i] == rvec_ext[Lp+Rp-2-d+i]
        start = Lp + Rp - 2 - d
        gj = lax.dynamic_slice_in_dim(gj_rext, start, Lp, axis=1)
        orp = lax.dynamic_slice_in_dim(orp_rext, start, Lp, axis=1)
        rw = lax.dynamic_slice_in_dim(rw_rext, start, Lp, axis=1)
        jjj = d - ii
        valid = (jjj >= 0) & (jjj < Rdpb) & (ii < Ldpb) & \
            (jjj >= band_lo) & (jjj <= band_hi)

        M1s, X1s, Y1s = shift(M1), shift(X1), shift(Y1)
        M2s, X2s, Y2s = shift(M2), shift(X2), shift(Y2)

        # X: gap consuming left site i (candidates: ext, double, open)
        cx = jnp.stack([X1s + gj, Y1s + lgob, M1s + lngb + open_l_prev])
        bpx = jnp.argmax(cx, axis=0).astype(jnp.int32)
        vx = jnp.max(cx, axis=0)
        okx = valid & (ii > 0) & jnp.isfinite(vx)
        X = jnp.where(okx, vx, big_neg)
        bpx = jnp.where(okx, bpx, _NONE)

        # Y: gap consuming right site j (ext, double, open)
        cy = jnp.stack([Y1 + gext_i, X1 + lgob, M1 + lngb + orp])
        bpy = jnp.argmax(cy, axis=0).astype(jnp.int32)
        vy = jnp.max(cy, axis=0)
        oky = valid & (jjj > 0) & jnp.isfinite(vy)
        Y = jnp.where(oky, vy, big_neg)
        bpy = jnp.where(oky, bpy, _NONE)

        # M: match consuming both (m, x, y)
        wadd = lngb + ms + lw + rw
        cm = jnp.stack([M2s + lngb + wadd, X2s + wadd, Y2s + wadd])
        bpm = jnp.argmax(cm, axis=0).astype(jnp.int32)
        vm = jnp.max(cm, axis=0)
        okm = valid & (ii > 0) & (jjj > 0) & jnp.isfinite(vm)
        M = jnp.where(okm, vm, big_neg)
        bpm = jnp.where(okm, bpm, _NONE)

        bp = (bpm | (bpx << 2) | (bpy << 4)).astype(jnp.int8)

        # capture the corner cell on its diagonal (per-job position);
        # mask via where (not multiply) so -inf cells can't produce NaN
        hit = d == (Ldpb + Rdpb - 2)                    # (B, 1)
        oh = (corner_onehot > 0) & hit
        cap = jnp.stack([jnp.where(oh, M, 0).sum(1),
                         jnp.where(oh, X, 0).sum(1),
                         jnp.where(oh, Y, 0).sum(1)], axis=1)
        final = jnp.where(hit, cap, final)

        return (M, X, Y, M1, X1, Y1, final), bp

    ds = jnp.arange(1, D)
    carry, bps = lax.scan(
        step, (M1, X1, Y1, M2, X2, Y2, final),
        (ds, jnp.swapaxes(ms_sh, 0, 1)[1:]))
    final = carry[-1]
    # prepend the d=0 row (no backpointers) and restore batch-major order
    bps = jnp.swapaxes(bps, 0, 1)                   # (B, D-1, Lp)
    bp0 = jnp.full((B, 1, Lp), _NONE | (_NONE << 2) | (_NONE << 4),
                   jnp.int8)
    return jnp.concatenate([bp0, bps], axis=1), final


batched_sheared_fill = jax.jit(batched_sheared_core)


def sheared_core(ms_sh, gj_rext, orp_rext, rw_rext, gext_i, open_l, lw,
                 lng, lgo, Ldp, Rdp, band_lo, band_hi):
    """Single-pair wrapper over the batch-native core."""
    bp, final = batched_sheared_core(
        ms_sh[None], gj_rext[None], orp_rext[None], rw_rext[None],
        gext_i[None], open_l[None], lw[None],
        jnp.asarray(lng)[None], jnp.asarray(lgo)[None],
        jnp.asarray(Ldp)[None], jnp.asarray(Rdp)[None],
        band_lo[None], band_hi[None])
    return bp[0], final[0]


sheared_fill = jax.jit(sheared_core)


# ----------------------------------------------------------------------
def _shear(vals_2d, D):
    """(L, R) row-major -> (D, L) diagonal-major: out[i+j, i] = in[i, j]."""
    L, R = vals_2d.shape
    ext = jnp.concatenate(
        [vals_2d, jnp.zeros((L, 1), vals_2d.dtype)], axis=1)
    d_idx = jnp.arange(D)[None, :] - jnp.arange(L)[:, None]  # (L, D) = j
    idx = jnp.clip(d_idx, 0, R)
    return jnp.take_along_axis(ext, idx, axis=1).T  # (D, L)


def _shear_np(vals_2d: np.ndarray, D: int) -> np.ndarray:
    """Numpy twin of _shear for host-side batch prep (keeps per-job prep
    off the device so stacking a generation's jobs is one transfer).
    Row i of the result is three contiguous copies (vals[i, 0] before
    the row's first diagonal, the row, zeros after), so the cost is one
    pass over the output with no O(L x D) index arrays."""
    L, R = vals_2d.shape
    out = np.empty((L, D), vals_2d.dtype)
    for i in range(L):
        lo = min(i, D)
        hi = min(i + R, D)
        out[i, :lo] = vals_2d[i, 0]
        out[i, lo:hi] = vals_2d[i, :hi - lo]
        out[i, hi:] = 0
    # the .T view is fine: downstream np.stack copies exactly once
    return out.T


def _shear_vec(vec, D, L):
    """(R,) -> (D, L): out[d, i] = vec[d-i] (clamped; callers mask)."""
    ext = jnp.concatenate([vec, jnp.zeros((1,), vec.dtype)])
    d_idx = jnp.arange(D)[None, :] - jnp.arange(L)[:, None]
    idx = jnp.clip(d_idx, 0, vec.shape[0])
    return ext[idx].T


def prepare_sheared(left: SequenceGraph, right: SequenceGraph,
                    model: EvolModel, settings: AlignSettings,
                    dtype=np.float64, with_ms: bool = True):
    """Host-side input prep for the sheared kernel. with_ms=False skips
    the O(L*R) match-score table for banded consumers that gather
    scores in-scan (viterbi_banded builds them by one-hot contraction
    — a 200 kb pair would otherwise need ~300 GB here)."""
    L = left.num_sites() - 1
    R = right.num_sites() - 1
    D = L + R - 1

    lstates = np.asarray(left.states[:L], dtype=np.int32)
    rstates = np.asarray(right.states[:R], dtype=np.int32)
    ms = (model.log_score[np.ix_(lstates, rstates)].astype(dtype)
          if with_ms else None)

    m = model
    gext = m.log_gap_ext()
    gend = gext if settings.no_terminal_edges else m.log_gap_end_ext()
    gext_j = np.full(R, gext, dtype)
    gext_j[0] = gend
    gext_j[R - 1] = gend
    gext_i = np.full(L, gext, dtype)
    gext_i[0] = gend
    gext_i[L - 1] = gend

    lgo = dtype(m.log_gap_open())
    open_l = np.full(L, lgo, dtype)   # open_l[p] for predecessor row p
    open_r = np.full(R, lgo, dtype)
    if settings.reduced_terminal_gap_penalties:
        open_l[0] = 0.0
        open_r[0] = 0.0

    # pair-end read1 boundary (viterbi_alignment.cpp:866-884 gap type,
    # basic_alignment.h:497-513 zeroed open penalty at the boundary;
    # gap close is log(1.0)=0 everywhere so needs no vector)
    if settings.pair_end_reads:
        if 0 <= settings.x_read1_length < L:
            gext_i[settings.x_read1_length] = m.log_gap_break_ext()
            if settings.reduced_terminal_gap_penalties:
                open_l[settings.x_read1_length] = 0.0
        if 0 <= settings.y_read1_length < R:
            gext_j[settings.y_read1_length] = m.log_gap_break_ext()
            if settings.reduced_terminal_gap_penalties:
                open_r[settings.y_read1_length] = 0.0

    def edge_logw_vec(g, n):
        """lw[i] = f32-rounded log weight of site i's bwd edge,
        vectorized (the per-site Python loop dominated host prep on
        100-leaf families)."""
        out = np.zeros(n, dtype)
        if n <= 1:
            return out
        ids = np.fromiter((g.bwd[i][0] for i in range(1, n)),
                          np.int64, n - 1)
        w = np.asarray(g.edges.weight, np.float64)[ids]
        with np.errstate(divide="ignore"):
            out[1:] = np.where(w > 0,
                               np.log(w).astype(np.float32), NEG)
        return out

    lw = edge_logw_vec(left, L)
    rw = edge_logw_vec(right, R)

    # open_pen_r sheared at index j-1: orp_sh[d, i] = open_r[d-i-1]
    open_r_shifted = np.concatenate([[0.0], open_r[:-1]]).astype(dtype)

    return dict(
        L=L, R=R, D=D,
        ms=ms, gext_j=gext_j, gext_i=gext_i,
        open_l=open_l, open_r_shifted=open_r_shifted,
        lw=lw, rw=rw,
        lng=dtype(m.log_non_gap()), lgo=lgo,
    )


def _rext(vec_np, R, Rp, Lp, dtype):
    """Pad a column-indexed vector to Rp, reverse, and zero-extend so the
    kernel can slice diagonal rows: ext[Lp+Rp-2-d+i] == vec[d-i]."""
    v = np.zeros(Rp, dtype)
    v[:R] = vec_np
    return jnp.asarray(np.concatenate(
        [np.zeros(Lp - 1, dtype), v[::-1], np.zeros(Lp, dtype)]))


def _rext_np(vec_np, R, Rp, Lp, dtype):
    v = np.zeros(Rp, dtype)
    v[:R] = vec_np
    return np.concatenate(
        [np.zeros(Lp - 1, dtype), v[::-1], np.zeros(Lp, dtype)])


def shear_device_inputs(inp, Lp=None, Rp=None, upper=None, lower=None):
    """Build sheared kernel inputs (optionally padded to Lp/Rp buckets)
    as NUMPY arrays — prep stays on host so a generation's jobs can be
    batch-stacked and shipped to the device in one transfer per
    argument. upper/lower: optional per-row [min j, max j] band bounds
    (length L)."""
    L, R = inp["L"], inp["R"]
    Lp = Lp or L
    Rp = Rp or R
    D = Lp + Rp - 1
    dtype = inp["ms"].dtype

    ms = np.zeros((Lp, Rp), dtype)
    ms[:L, :R] = inp["ms"]
    ms_sh = _shear_np(ms, D)
    gj_rext = _rext_np(inp["gext_j"], R, Rp, Lp, dtype)
    orp_rext = _rext_np(inp["open_r_shifted"], R, Rp, Lp, dtype)
    rw_rext = _rext_np(inp["rw"], R, Rp, Lp, dtype)
    gext_i = np.zeros(Lp, dtype)
    gext_i[:L] = inp["gext_i"]
    open_l = np.zeros(Lp, dtype)
    open_l[:L] = inp["open_l"]
    lw = np.zeros(Lp, dtype)
    lw[:L] = inp["lw"]
    band_lo = np.zeros(Lp, np.int32)
    if upper is not None:
        band_lo[:L] = np.asarray(upper[:L], np.int32)
    band_hi = np.full(Lp, Rp - 1, np.int32)
    if lower is not None:
        band_hi[:L] = np.asarray(lower[:L], np.int32)
    return (ms_sh, gj_rext, orp_rext, rw_rext, gext_i, open_l, lw,
            dtype.type(inp["lng"]), dtype.type(inp["lgo"]),
            np.int32(L), np.int32(R), band_lo, band_hi)


# ----------------------------------------------------------------------
class _ShearedCells:
    """Oracle-style cell accessor over the packed bp planes."""

    def __init__(self, bp, left, right):
        self.bp = np.asarray(bp)
        self.left = left
        self.right = right

    def cell(self, which, i, j) -> MatrixPtr:
        code = int(self.bp[i + j, i])
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


def _end_corner_linear(final, left, right, model, L, R):
    """End-corner resolution for chain graphs: the stop sites have one
    bwd edge each, so only the corner cell's three values matter
    (viterbi_alignment.cpp:1440-1567 collapses to three candidates)."""
    mx = MatrixPtr()
    le = left.bwd[L][0]
    re = right.bwd[R][0]

    def logw(g, e):
        w = float(g.edges.weight[e])
        return float(np.float32(np.log(w))) if w > 0 else NEG

    mM, mX, mY = [float(v) for v in final]
    # m_match
    sc = mM + model.log_non_gap() + logw(left, le) + logw(right, re)
    if first_is_bigger(sc, mx.score):
        mx.score = sc
        mx.x_ind = L - 1
        mx.y_ind = R - 1
        mx.x_edge_ind = le
        mx.y_edge_ind = re
        mx.matrix = M_MAT
    best = mx.score
    # x gap close
    sc = mX + 0.0
    if first_is_bigger(sc, mx.score):
        mx.score = sc
        mx.matrix = X_MAT
        mx.x_ind = L - 1
        mx.x_edge_ind = le
        mx.y_edge_ind = -1
    if first_is_bigger(mx.score, best):
        best = mx.score
        mx.y_ind = R - 1
    # y gap close
    sc = mY + 0.0
    if first_is_bigger(sc, mx.score):
        mx.score = sc
        mx.matrix = Y_MAT
        mx.y_ind = R - 1
        mx.y_edge_ind = re
        mx.x_edge_ind = -1
    if first_is_bigger(mx.score, best):
        mx.x_ind = L - 1
    return mx


def _bucket(n: int) -> int:
    """Pad to a small set of shape buckets so jit compiles are reused."""
    if n <= 128:
        return -(-n // 32) * 32
    if n <= 1024:
        return -(-n // 128) * 128
    p = 1024
    while p < n:
        p *= 2
    return p


def sheared_align_path(left: SequenceGraph, right: SequenceGraph,
                       model: EvolModel, settings: AlignSettings,
                       left_branch_length: float = 0.0,
                       right_branch_length: float = 0.0,
                       dtype=np.float64,
                       band=None):
    """Full fast path: sheared device fill + host backtrack.

    band: optional (upper, lower) per-row column bounds from the
    anchoring pipeline. If the banded DP cannot reach the end corner the
    full matrix is recomputed (the reference's anchored-DP fallback,
    viterbi_alignment.cpp:298-317).

    The fill is the scan core below or, on a GPU, the Hopper kernel
    (backend.fill_impl); both give the same backpointer plane."""
    from .viterbi_jax import _backtrack_arrays
    from .backend import fill_impl, count_fill, KERNEL

    L = left.num_sites() - 1
    R = right.num_sites() - 1
    Lp, Rp = _bucket(L), _bucket(R)
    if fill_impl("linear") == KERNEL:
        from .hopper import linear_job, linear_fill

        def fill(bnd):
            job = linear_job(left, right, model, settings, Lp, Rp,
                             band=bnd)
            bp, fin = linear_fill([job], Lp + Rp - 1, Lp)
            return bp[0], fin[0]
        impl = KERNEL
    else:
        inp = prepare_sheared(left, right, model, settings, dtype)

        def fill(bnd):
            args = shear_device_inputs(
                inp, Lp=Lp, Rp=Rp, upper=bnd[0] if bnd else None,
                lower=bnd[1] if bnd else None)
            bp, final = sheared_fill(*args)
            return bp, np.asarray(final)
        impl = "scan"

    bp, final = fill(band)
    count_fill(impl)
    if band is not None and not np.isfinite(final).any():
        # anchored alignment failed: retry with the full matrix
        bp, final = fill(None)
        count_fill(impl)

    cells = _ShearedCells(bp, left, right)
    end = _end_corner_linear(final, left, right, model, L, R)
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, left, right, PathPtr(end, True), L, R,
                             left_branch_length, right_branch_length)
    return path, end
