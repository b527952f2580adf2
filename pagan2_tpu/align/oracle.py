"""Host-side reference implementation of the pairwise graph-vs-graph
3-state Viterbi DP.

This is a literal (slow, loop-based) transliteration of
Viterbi_alignment::align (src/main/viterbi_alignment.cpp:187-465) with the
exact candidate evaluation order and strict-greater first-wins tie-breaks
(basic_alignment.h:449-462). It is the ground-truth oracle the vectorized
JAX / CUDA kernels are tested against, and the fallback engine for tiny
problems.

Scores are float64; model parameters arrive float32-rounded from
EvolModel, matching the reference's double-DP-over-float-params layout.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import math

import numpy as np

from ..graph.sequence_graph import SequenceGraph, BREAK_START_SITE, REAL_SITE
from ..models.evol_model import EvolModel
from .settings import (AlignSettings, X_MAT, Y_MAT, M_MAT,
                       NORMAL_GAP, END_GAP, PAIR_BREAK_GAP)

NEG = -np.inf


@dataclass
class MatrixPtr:
    """Matrix_pointer (basic_alignment.h:33-50)."""
    score: float = NEG
    fwd_score: float = 0.0
    bwd_score: float = 0.0
    full_score: float = 0.0
    x_ind: int = -1
    y_ind: int = -1
    x_edge_ind: int = -1
    y_edge_ind: int = -1
    matrix: int = -1
    path_index: int = -1

    def copy(self) -> "MatrixPtr":
        return MatrixPtr(self.score, self.fwd_score, self.bwd_score,
                         self.full_score, self.x_ind, self.y_ind,
                         self.x_edge_ind, self.y_edge_ind, self.matrix,
                         self.path_index)


@dataclass
class PathPtr:
    """Path_pointer (basic_alignment.h:52-65)."""
    mp: MatrixPtr
    real_site: bool
    branch_length_increase: float = 0.0
    branch_count_increase: int = 0


class _ColView:
    """Column slice of a row-major matrix-of-pointers (Tunnel_slice stand-in)."""
    __slots__ = ("mat", "j")

    def __init__(self, mat, j):
        self.mat = mat
        self.j = j

    def __getitem__(self, i):
        return self.mat[i][self.j]


def first_is_bigger(a: float, b: float) -> bool:
    if a == NEG and b == NEG:
        return False
    return a > b


def mark_no_gap_penalty_sites(g) -> int:
    """Strip pair-end break markers from one graph and return the
    read1-length boundary (mark_no_gap_penalty_sites,
    basic_alignment.h:639-674: BREAK_START records the boundary and
    becomes real; the BREAK_STOP right after it becomes real and stops
    the scan). Returns -1 when no boundary is present."""
    from ..graph.sequence_graph import BREAK_STOP_SITE
    read1 = -1
    for i in range(g.num_sites()):
        if g.site_type[i] == BREAK_START_SITE:
            read1 = i
            g.site_type[i] = REAL_SITE
        if g.site_type[i] == BREAK_STOP_SITE:
            g.site_type[i] = REAL_SITE
            break
    return read1


class PairAligner:
    """One pairwise alignment: fill, (optional) fwd/bwd full probability,
    backtrack. Produces the DP path; graph building lives in ancestral.py."""

    def __init__(self, left: SequenceGraph, right: SequenceGraph,
                 model: EvolModel, settings: AlignSettings,
                 left_branch_length: float = 0.0,
                 right_branch_length: float = 0.0):
        self.left = left
        self.right = right
        self.model = model
        self.s = settings
        self.left_branch_length = left_branch_length
        self.right_branch_length = right_branch_length

        self.L = left.num_sites() - 1    # DP rows 0..L-? (shape L)
        self.R = right.num_sites() - 1

        # no-gap-penalty bookkeeping (mark_no_gap_penalty_sites,
        # basic_alignment.h:633-676)
        self.x_length = left.num_sites() if settings.reduced_terminal_gap_penalties else -1
        self.y_length = right.num_sites() if settings.reduced_terminal_gap_penalties else -1
        # read1 boundaries may arrive pre-stripped via settings
        # (align_pair marks them once so every engine sees them)
        self.x_read1_length = settings.x_read1_length
        self.y_read1_length = settings.y_read1_length
        if settings.pair_end_reads and settings.reduced_terminal_gap_penalties:
            xr = mark_no_gap_penalty_sites(left)
            if xr >= 0:
                self.x_read1_length = xr
            yr = mark_no_gap_penalty_sites(right)
            if yr >= 0:
                self.y_read1_length = yr

        n, m = self.L, self.R
        self.M = [[MatrixPtr() for _ in range(m)] for _ in range(n)]
        self.X = [[MatrixPtr() for _ in range(m)] for _ in range(n)]
        self.Y = [[MatrixPtr() for _ in range(m)] for _ in range(n)]

    # -- helpers ------------------------------------------------------
    def _log_gap_open_penalty(self, prev_site: int, is_x: bool) -> float:
        """basic_alignment.h:490-513"""
        s = self.s
        if s.reduced_terminal_gap_penalties:
            if prev_site == 0:
                return 0.0
            if s.pair_end_reads:
                if is_x and prev_site == self.x_read1_length:
                    return 0.0
                if not is_x and prev_site == self.y_read1_length:
                    return 0.0
        return self.model.log_gap_open()

    def _log_gap_close_penalty(self, this_site: int, is_x: bool) -> float:
        """basic_alignment.h:515-542. NB the terminal branch
        (this_site == x_length = sites_length()) can never fire — edge
        ends max out at sites_length()-1 — in the REFERENCE too
        (basic_alignment.h:519,636); it is inert either way because
        log_gap_close() is 0. Replicated verbatim, do not "fix"."""
        s = self.s
        if s.reduced_terminal_gap_penalties:
            if is_x and this_site == self.x_length:
                return 0.0
            if not is_x and this_site == self.y_length:
                return 0.0
            if s.pair_end_reads:
                if is_x and this_site == self.x_read1_length + 1:
                    return 0.0
                if not is_x and this_site == self.y_read1_length + 1:
                    return 0.0
        return self.model.log_gap_close()

    # -- scoring kernels (viterbi_alignment.cpp:2029-2255) ------------
    def _score_gap_ext(self, edge_id, seq, z_col, mx: MatrixPtr,
                       is_x: bool, gap_type: int):
        prev = seq.edges.start[edge_id]
        m = self.model
        if gap_type == END_GAP:
            ext = m.log_gap_end_ext()
        elif gap_type == PAIR_BREAK_GAP:
            ext = m.log_gap_break_ext()
        else:
            ext = m.log_gap_ext()
        sc = z_col[prev].score + ext
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            if is_x:
                mx.matrix = X_MAT
                mx.x_ind = prev
                mx.x_edge_ind = edge_id
            else:
                mx.matrix = Y_MAT
                mx.y_ind = prev
                mx.y_edge_ind = edge_id
        if self.s.compute_full_score:
            # the fwd full-prob pass always uses the plain extension prob,
            # even at end/pair-break gaps (viterbi_alignment.cpp:2151-2154)
            mx.fwd_score += z_col[prev].fwd_score * m.ext_prob

    def _score_gap_double(self, edge_id, seq, w_col, mx: MatrixPtr,
                          is_x: bool):
        prev = seq.edges.start[edge_id]
        m = self.model
        sc = w_col[prev].score + m.log_gap_close() + m.log_gap_open()
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            if is_x:
                mx.matrix = Y_MAT
                mx.x_ind = prev
                mx.x_edge_ind = edge_id
            else:
                mx.matrix = X_MAT
                mx.y_ind = prev
                mx.y_edge_ind = edge_id
        if self.s.compute_full_score:
            mx.fwd_score += w_col[prev].fwd_score * m.gap_close() * m.gap_open()

    def _score_gap_open(self, edge_id, seq, m_col, mx: MatrixPtr,
                        is_x: bool):
        prev = seq.edges.start[edge_id]
        m = self.model
        sc = m_col[prev].score + m.log_non_gap() + \
            self._log_gap_open_penalty(prev, is_x)
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.matrix = M_MAT
            if is_x:
                mx.x_ind = prev
                mx.x_edge_ind = edge_id
            else:
                mx.y_ind = prev
                mx.y_edge_ind = edge_id
        if self.s.compute_full_score:
            mx.fwd_score += m_col[prev].fwd_score * m.non_gap() * m.gap_open()

    def _score_gap_close(self, edge_id, seq, z_col, mx: MatrixPtr,
                         is_x: bool):
        prev = seq.edges.start[edge_id]
        this = seq.edges.end[edge_id]
        sc = z_col[prev].score + self._log_gap_close_penalty(this, is_x)
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            if is_x:
                mx.matrix = X_MAT
                mx.x_ind = prev
                mx.x_edge_ind = edge_id
                mx.y_edge_ind = -1
            else:
                mx.matrix = Y_MAT
                mx.y_ind = prev
                mx.y_edge_ind = edge_id
                mx.x_edge_ind = -1
        if self.s.compute_full_score:
            mx.fwd_score += z_col[prev].fwd_score * self.model.gap_close()

    def _score_match(self, which, le, re, log_match, mx: MatrixPtr,
                     match_p):
        """score_{m,x,y}_match (viterbi_alignment.cpp:2029-2112):
        edge weights are added for match moves."""
        lw = self.left_logw[le]
        rw = self.right_logw[re]
        lp = self.left.edges.start[le]
        rp = self.right.edges.start[re]
        mat = (self.M, self.X, self.Y)[which]
        sc = mat[lp][rp].score + log_match + lw + rw
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.x_ind = lp
            mx.y_ind = rp
            mx.x_edge_ind = le
            mx.y_edge_ind = re
            mx.matrix = (M_MAT, X_MAT, Y_MAT)[which]
        if self.s.compute_full_score:
            mx.fwd_score += mat[lp][rp].fwd_score * match_p * \
                self.left_w[le] * self.right_w[re]

    # -- cell fill (viterbi_alignment.cpp:856-971) --------------------
    def compute_fwd_scores(self, i: int, j: int):
        if i == 0 and j == 0:
            return
        s = self.s
        j_gap_type = NORMAL_GAP
        i_gap_type = NORMAL_GAP
        if (j == 0 or j == self.R - 1) and not s.no_terminal_edges:
            j_gap_type = END_GAP
        if s.pair_end_reads and j == self.y_read1_length:
            j_gap_type = PAIR_BREAK_GAP
        if (i == 0 or i == self.L - 1) and not s.no_terminal_edges:
            i_gap_type = END_GAP
        if s.pair_end_reads and i == self.x_read1_length:
            i_gap_type = PAIR_BREAK_GAP

        max_x = self.X[i][j]
        max_y = self.Y[i][j]
        max_m = self.M[i][j]

        if i > 0:
            x_col = _ColView(self.X, j)
            y_col = _ColView(self.Y, j)
            m_col = _ColView(self.M, j)
            for e in self.left.bwd[i]:
                self._score_gap_ext(e, self.left, x_col, max_x, True,
                                    j_gap_type)
                self._score_gap_double(e, self.left, y_col, max_x, True)
                self._score_gap_open(e, self.left, m_col, max_x, True)
            max_x.y_ind = j

        if j > 0:
            x_row = self.X[i]
            y_row = self.Y[i]
            m_row = self.M[i]
            for e in self.right.bwd[j]:
                self._score_gap_ext(e, self.right, y_row, max_y, False,
                                    i_gap_type)
                self._score_gap_double(e, self.right, x_row, max_y, False)
                self._score_gap_open(e, self.right, m_row, max_y, False)
            max_y.x_ind = i

        if i > 0 and j > 0:
            self._match_cell(i, j, max_m)

    def _match_cell(self, i: int, j: int, max_m: MatrixPtr):
        """iterate_bwd_edges_for_match (viterbi_alignment.cpp:1353-1436):
        pair order row-major (left edge outer), per pair order m, x, y."""
        lb = self.left.bwd[i]
        rb = self.right.bwd[j]
        if not lb or not rb:
            return
        m = self.model
        log_match_score = m.log_score[self.left.states[i],
                                      self.right.states[j]]
        m_log = 2.0 * m.log_non_gap() + log_match_score
        x_log = self._log_gap_close_penalty(
            self.left.edges.end[lb[0]], True) + m.log_non_gap() + log_match_score
        y_log = self._log_gap_close_penalty(
            self.right.edges.end[rb[0]], False) + m.log_non_gap() + log_match_score

        m_p = x_p = y_p = 0.0
        if self.s.compute_full_score:
            match_p = m.score[self.left.states[i], self.right.states[j]]
            m_p = m.non_gap() * m.non_gap() * match_p
            x_p = m.gap_close() * m.non_gap() * match_p
            y_p = m.gap_close() * m.non_gap() * match_p

        for le in lb:
            for re in rb:
                self._score_match(0, le, re, m_log, max_m, m_p)
                self._score_match(1, le, re, x_log, max_m, x_p)
                self._score_match(2, le, re, y_log, max_m, y_p)

    # -- end corner (viterbi_alignment.cpp:1440-1567) -----------------
    def _end_corner(self) -> MatrixPtr:
        # the corner is resolved on the stop sites: left site index
        # i_max = sites_length-1 = L (viterbi_alignment.cpp:289-295)
        lb = self.left.bwd[self.L]
        rb = self.right.bwd[self.R]
        mx = MatrixPtr()
        if not lb or not rb:
            return mx
        m = self.model
        m_log = m.log_non_gap()
        m_p = m.non_gap()

        def gap_close_left(le, mx):
            self._score_gap_close(le, self.left, _ColView(self.X, self.R - 1),
                                  mx, True)

        def gap_close_right(re, mx):
            z_row = self.Y[self.L - 1]
            self._score_gap_close(re, self.right, z_row, mx, False)

        le0, re0 = lb[0], rb[0]
        self._score_match(0, le0, re0, m_log, mx, m_p)
        best = mx.score
        gap_close_left(le0, mx)
        if first_is_bigger(mx.score, best):
            best = mx.score
            mx.y_ind = self.R - 1
        gap_close_right(re0, mx)
        if first_is_bigger(mx.score, best):
            best = mx.score
            mx.x_ind = self.L - 1

        for re in rb[1:]:
            self._score_match(0, le0, re, m_log, mx, m_p)
            if first_is_bigger(mx.score, best):
                best = mx.score
            gap_close_right(re, mx)
            if first_is_bigger(mx.score, best):
                best = mx.score
                mx.x_ind = self.L - 1

        for le in lb[1:]:
            self._score_match(0, le, re0, m_log, mx, m_p)
            if first_is_bigger(mx.score, best):
                best = mx.score
            gap_close_left(le, mx)
            if first_is_bigger(mx.score, best):
                best = mx.score
                mx.y_ind = self.R - 1
            for re in rb[1:]:
                self._score_match(0, le, re, m_log, mx, m_p)
                if first_is_bigger(mx.score, best):
                    best = mx.score
                gap_close_right(re, mx)
                if first_is_bigger(mx.score, best):
                    best = mx.score
                    mx.x_ind = self.L - 1
        return mx

    # -- bwd full probability (viterbi_alignment.cpp:329-371) ----------
    def _init_bwd_corner(self):
        """initialise_array_corner_bwd (viterbi_alignment.cpp:740-830):
        seed bwd at every bwd-edge pair of the two stop sites."""
        m = self.model
        self.M[self.L - 1][self.R - 1].bwd_score = m.non_gap()
        lb = self.left.bwd[self.L]
        rb = self.right.bwd[self.R]
        if lb and rb:
            for le in lb:
                for re in rb:
                    li = self.left.edges.start[le]
                    ri = self.right.edges.start[re]
                    self.M[li][ri].bwd_score = (
                        m.non_gap() * self.left_w[le] * self.right_w[re])

    def _compute_bwd_full_score(self, i: int, j: int):
        """compute_bwd_full_score (viterbi_alignment.cpp:975-1027) using
        the fwd-edge kernels (:1571-1686, 2259-2305)."""
        m = self.model
        if i == self.L and j == self.R:
            return
        max_x = self.X[i][j]
        max_y = self.Y[i][j]
        max_m = self.M[i][j]

        if i < self.L:
            for e in self.left.fwd[i]:
                nxt = self.left.edges.end[e]
                if nxt < self.L:
                    xb = self.X[nxt][j].bwd_score
                    max_x.bwd_score += xb * m.ext_prob
                    max_y.bwd_score += xb * m.gap_close() * m.gap_open()
                    max_m.bwd_score += xb * m.non_gap() * m.gap_open()
        if j < self.R:
            for e in self.right.fwd[j]:
                nxt = self.right.edges.end[e]
                if nxt < self.R:
                    yb = self.Y[i][nxt].bwd_score
                    max_y.bwd_score += yb * m.ext_prob
                    max_x.bwd_score += yb * m.gap_close() * m.gap_open()
                    max_m.bwd_score += yb * m.non_gap() * m.gap_open()
        if i < self.L and j < self.R:
            # score_match_bwd: match score is taken at the *target* cell
            for le in self.left.fwd[i]:
                lp = self.left.edges.end[le]
                if lp >= self.L:
                    continue
                for re in self.right.fwd[j]:
                    rp = self.right.edges.end[re]
                    if rp >= self.R:
                        continue
                    ms = m.score[self.left.states[lp],
                                 self.right.states[rp]]
                    t = (self.M[lp][rp].bwd_score * ms *
                         self.left_w[le] * self.right_w[re])
                    max_x.bwd_score += t * m.gap_close() * m.non_gap()
                    max_y.bwd_score += t * m.gap_close() * m.non_gap()
                    max_m.bwd_score += t * m.non_gap() * m.non_gap()

    def compute_bwd_posterior(self, end: MatrixPtr):
        """Backward pass + per-cell posterior full_score = fwd*bwd/total
        with the fwd/bwd 1% consistency check
        (viterbi_alignment.cpp:327-371, 1029-1034)."""
        from ..utils import log_out
        self._init_bwd_corner()
        for j in range(self.R - 1, -1, -1):
            for i in range(self.L - 1, -1, -1):
                self._compute_bwd_full_score(i, j)
        total = end.fwd_score
        bwd_total = self.M[0][0].bwd_score
        self.bwd_full_probability = bwd_total
        ratio = total / bwd_total if bwd_total else 0.0
        if ratio < 0.99 or ratio > 1.01:
            log_out("Problem in computation? fwd: %g, bwd: %g"
                    % (total, bwd_total), 1)
        for j in range(self.R):
            for i in range(self.L):
                for mat in (self.M, self.X, self.Y):
                    c = mat[i][j]
                    c.full_score = c.fwd_score * c.bwd_score / total

    # -- stochastic backtrack (viterbi_alignment.cpp:1193-1322) --------
    def _draw(self, cands: list[MatrixPtr], rng) -> MatrixPtr:
        total = sum(c.score for c in cands)
        r = total * rng.random()
        acc = 0.0
        for c in cands:
            acc += c.score
            if acc >= r:
                return c
        return cands[-1]

    def _sampled_end_corner(self, rng) -> MatrixPtr:
        """iterate_bwd_edges_for_sampled_end_corner
        (viterbi_alignment.cpp:1908-2028)."""
        m = self.model
        lb = self.left.bwd[self.L]
        rb = self.right.bwd[self.R]
        cands: list[MatrixPtr] = []

        def add_m(le, re):
            li = self.left.edges.start[le]
            ri = self.right.edges.start[re]
            sc = (self.M[li][ri].fwd_score * m.non_gap() *
                  self.left_w[le] * self.right_w[re])
            cands.append(MatrixPtr(score=sc, x_ind=li, y_ind=ri,
                                   x_edge_ind=le, y_edge_ind=re,
                                   matrix=M_MAT))

        def add_close(e, is_x):
            prev = (self.left if is_x else self.right).edges.start[e]
            w = (self.left_w if is_x else self.right_w)[e]
            if is_x:
                sc = self.X[prev][self.R - 1].fwd_score * m.gap_close() * w
                cands.append(MatrixPtr(score=sc, x_ind=prev,
                                       y_ind=self.R - 1, x_edge_ind=e,
                                       matrix=X_MAT))
            else:
                sc = self.Y[self.L - 1][prev].fwd_score * m.gap_close() * w
                cands.append(MatrixPtr(score=sc, x_ind=self.L - 1,
                                       y_ind=prev, y_edge_ind=e,
                                       matrix=Y_MAT))

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
        return self._draw(cands, rng).copy()

    def _sampled_match(self, i: int, j: int, rng) -> MatrixPtr:
        """iterate_bwd_edges_for_sampled_match
        (viterbi_alignment.cpp:1781-1905)."""
        m = self.model
        ms = m.score[self.left.states[i], self.right.states[j]]
        m_match = m.non_gap() * m.non_gap() * ms
        z_match = m.gap_close() * m.non_gap() * ms
        cands: list[MatrixPtr] = []

        def add(le, re):
            li = self.left.edges.start[le]
            ri = self.right.edges.start[re]
            w = self.left_w[le] * self.right_w[re]
            for mat, mp_mat, fac in ((self.M, M_MAT, m_match),
                                     (self.X, X_MAT, z_match),
                                     (self.Y, Y_MAT, z_match)):
                sc = mat[li][ri].fwd_score * fac * w
                cands.append(MatrixPtr(score=sc, x_ind=li, y_ind=ri,
                                       x_edge_ind=le, y_edge_ind=re,
                                       matrix=mp_mat))

        lb = self.left.bwd[i]
        rb = self.right.bwd[j]
        le0, re0 = lb[0], rb[0]
        add(le0, re0)
        for re in rb[1:]:
            add(le0, re)
        for le in lb[1:]:
            add(le, re0)
            for re in rb[1:]:
                add(le, re)
        sp = self._draw(cands, rng).copy()
        cell = self.M[i][j]
        sp.fwd_score = cell.fwd_score
        sp.bwd_score = cell.bwd_score
        sp.full_score = cell.full_score
        return sp

    def _sampled_gap(self, i: int, j: int, is_x: bool, rng) -> MatrixPtr:
        """iterate_bwd_edges_for_sampled_gap
        (viterbi_alignment.cpp:1664-1779, 2360-2425)."""
        m = self.model
        cands: list[MatrixPtr] = []
        if is_x:
            seq, w = self.left, self.left_w
            Z = _ColView(self.X, j)
            W = _ColView(self.Y, j)
            Mm = _ColView(self.M, j)
            site = i
        else:
            seq, w = self.right, self.right_w
            Z = self.Y[i]
            W = self.X[i]
            Mm = self.M[i]
            site = j

        def mk(sc, prev, mat, e):
            mp = MatrixPtr(score=sc, matrix=mat)
            if is_x:
                mp.x_ind = prev
                mp.x_edge_ind = e
            else:
                mp.y_ind = prev
                mp.y_edge_ind = e
            cands.append(mp)

        for e in seq.bwd[site]:
            prev = seq.edges.start[e]
            mk(Z[prev].fwd_score * m.ext_prob * w[e], prev,
               X_MAT if is_x else Y_MAT, e)
            mk(W[prev].fwd_score * m.gap_close() * m.gap_open() * w[e],
               prev, Y_MAT if is_x else X_MAT, e)
            mk(Mm[prev].fwd_score * m.non_gap() * m.gap_open() * w[e],
               prev, M_MAT, e)
        sp = self._draw(cands, rng).copy()
        cell = (self.X if is_x else self.Y)[i][j]
        sp.fwd_score = cell.fwd_score
        sp.bwd_score = cell.bwd_score
        sp.full_score = cell.full_score
        if is_x:
            sp.y_ind = j
        else:
            sp.x_ind = i
        return sp

    def sample_path(self, rng):
        """sample_new_path (viterbi_alignment.cpp:1193-1322): stochastic
        backtrack drawing each move proportional to fwd probability."""
        end = self._sampled_end_corner(rng)
        end.bwd_score = 1.0
        end.full_score = 1.0
        fp = PathPtr(end, True)

        stack: list[PathPtr] = []
        left, right = self.left, self.right
        vit_mat = fp.mp.matrix
        x_ind = fp.mp.x_ind
        y_ind = fp.mp.y_ind
        if fp.mp.x_edge_ind >= 0:
            left.edges.used[fp.mp.x_edge_ind] = True
        if fp.mp.y_edge_ind >= 0:
            right.edges.used[fp.mp.y_edge_ind] = True

        ij = [self.L - 1, self.R - 1]

        def insert_preexisting_gap(x_ind, y_ind):
            while x_ind < ij[0]:
                self._push_gap(stack, ij[0] - 1, ij[1], X_MAT,
                               self.left_branch_length)
                ij[0] -= 1
            while y_ind < ij[1]:
                self._push_gap(stack, ij[0], ij[1] - 1, Y_MAT,
                               self.right_branch_length)
                ij[1] -= 1

        def insert_pp(pp):
            if ij[0] > 0 or ij[1] > 0:
                stack.append(pp)

        insert_preexisting_gap(x_ind, y_ind)
        insert_pp(fp)

        while True:
            i, j = ij
            if vit_mat == M_MAT:
                bwd_p = self._sampled_match(i, j, rng)
                vit_mat = bwd_p.matrix
                x_ind = bwd_p.x_ind
                y_ind = bwd_p.y_ind
                left.edges.used[bwd_p.x_edge_ind] = True
                right.edges.used[bwd_p.y_edge_ind] = True
                pp = PathPtr(bwd_p, True)
                ij[0] -= 1
                ij[1] -= 1
            elif vit_mat == X_MAT:
                bwd_p = self._sampled_gap(i, j, True, rng)
                vit_mat = bwd_p.matrix
                x_ind = bwd_p.x_ind
                y_ind = bwd_p.y_ind
                left.edges.used[bwd_p.x_edge_ind] = True
                pp = PathPtr(bwd_p, True)
                ij[0] -= 1
            elif vit_mat == Y_MAT:
                bwd_p = self._sampled_gap(i, j, False, rng)
                vit_mat = bwd_p.matrix
                x_ind = bwd_p.x_ind
                y_ind = bwd_p.y_ind
                right.edges.used[bwd_p.y_edge_ind] = True
                pp = PathPtr(bwd_p, True)
                ij[1] -= 1
            else:
                raise RuntimeError(f"incorrect sampled pointer {vit_mat}")
            insert_preexisting_gap(x_ind, y_ind)
            insert_pp(pp)
            if ij[0] < 1 and ij[1] < 1:
                break

        return stack[::-1], end

    # -- public -------------------------------------------------------
    def fill(self):
        """Forward fill + end corner (+ bwd/posterior when full score is
        on). Returns the end-corner pointer."""
        # cache edge weights as float32-rounded logs (Edge stores both)
        ew = self.left.edges.weight
        self.left_logw = [float(np.float32(np.log(np.float64(w)))) for w in ew]
        self.left_w = [float(w) for w in ew]
        ew = self.right.edges.weight
        self.right_logw = [float(np.float32(np.log(np.float64(w)))) for w in ew]
        self.right_w = [float(w) for w in ew]

        self.M[0][0].score = 0.0
        self.M[0][0].fwd_score = 1.0

        for j in range(self.R):
            for i in range(self.L):
                self.compute_fwd_scores(i, j)

        end = self._end_corner()
        end.bwd_score = 1.0
        end.full_score = 1.0
        if self.s.compute_full_score:
            self.compute_bwd_posterior(end)
        return end

    def align(self):
        """Fill + corner + backtrack. Returns (path, end_ptr)."""
        end = self.fill()
        path = self._backtrack(PathPtr(end, True))
        return path, end

    def print_matrices(self) -> str:
        """Debug dump of the three DP matrices
        (Viterbi_alignment::print_matrices, viterbi_alignment.cpp:
        2913-3096): per matrix the backpointer-matrix ids and Viterbi
        scores, plus log fwd/bwd/full probabilities when the full score
        was computed. Rows are j (right sites), columns i (left sites),
        matching the reference's transposed loops. Emitted at noise
        level 5 (viterbi_alignment.cpp:369)."""
        full = self.s.compute_full_score
        out = []

        def grid(tag, get, fmt="%8.4f"):
            out.append(tag)
            for j in range(self.R):
                out.append(" ".join(fmt % get(i, j)
                                    for i in range(self.L)))
            out.append("")

        def safe_log(v):
            return math.log(v) if v > 0 else float("-inf")

        for tag, mat in (("m", self.M), ("x", self.X), ("y", self.Y)):
            grid(tag, lambda i, j, m=mat: m[i][j].matrix, "%d")
            grid(tag, lambda i, j, m=mat: m[i][j].score)
            if full:
                grid(tag, lambda i, j, m=mat: safe_log(m[i][j].fwd_score))
                grid(tag, lambda i, j, m=mat: safe_log(m[i][j].bwd_score))
                grid(tag, lambda i, j, m=mat: safe_log(m[i][j].full_score))
        return "\n".join(out)

    # -- backtrack (viterbi_alignment.cpp:1038-1189) ------------------
    def _backtrack(self, fp: PathPtr):
        stack: list[PathPtr] = []
        left, right = self.left, self.right

        vit_mat = fp.mp.matrix
        x_ind = fp.mp.x_ind
        y_ind = fp.mp.y_ind
        first_x_site = True
        first_y_site = True

        if fp.mp.x_edge_ind >= 0:
            left.edges.used[fp.mp.x_edge_ind] = True
        if fp.mp.y_edge_ind >= 0:
            right.edges.used[fp.mp.y_edge_ind] = True

        j = self.R - 1
        i = self.L - 1
        max_i, max_j = i + 1, j + 1

        ij = [i, j]

        def insert_preexisting_gap(x_ind, y_ind):
            while x_ind < ij[0]:
                self._push_gap(stack, ij[0] - 1, ij[1], X_MAT,
                               self.left_branch_length)
                ij[0] -= 1
            while y_ind < ij[1]:
                self._push_gap(stack, ij[0], ij[1] - 1, Y_MAT,
                               self.right_branch_length)
                ij[1] -= 1

        def insert_pp(pp):
            if ij[0] > 0 or ij[1] > 0:
                stack.append(pp)

        insert_preexisting_gap(x_ind, y_ind)
        insert_pp(fp)

        while True:
            i, j = ij
            if vit_mat == M_MAT:
                cell = self.M[i][j]
                if first_x_site:
                    e = left.find_fwd_edge(x_ind, max_i)
                    if e >= 0:
                        left.edges.used[e] = True
                    first_x_site = False
                if first_y_site:
                    e = right.find_fwd_edge(y_ind, max_j)
                    if e >= 0:
                        right.edges.used[e] = True
                    first_y_site = False
                vit_mat = cell.matrix
                x_ind = cell.x_ind
                y_ind = cell.y_ind
                left.edges.used[cell.x_edge_ind] = True
                right.edges.used[cell.y_edge_ind] = True
                pp = PathPtr(cell.copy(), True)
                ij[0] -= 1
                ij[1] -= 1
                insert_preexisting_gap(x_ind, y_ind)
                insert_pp(pp)
            elif vit_mat == X_MAT:
                cell = self.X[i][j]
                if first_x_site:
                    e = left.find_fwd_edge(x_ind, max_i)
                    if e >= 0:
                        left.edges.used[e] = True
                    first_x_site = False
                vit_mat = cell.matrix
                x_ind = cell.x_ind
                y_ind = cell.y_ind
                left.edges.used[cell.x_edge_ind] = True
                pp = PathPtr(cell.copy(), True)
                ij[0] -= 1
                insert_preexisting_gap(x_ind, y_ind)
                insert_pp(pp)
            elif vit_mat == Y_MAT:
                cell = self.Y[i][j]
                if first_y_site:
                    e = right.find_fwd_edge(y_ind, max_j)
                    if e >= 0:
                        right.edges.used[e] = True
                    first_y_site = False
                vit_mat = cell.matrix
                x_ind = cell.x_ind
                y_ind = cell.y_ind
                right.edges.used[cell.y_edge_ind] = True
                pp = PathPtr(cell.copy(), True)
                ij[1] -= 1
                insert_preexisting_gap(x_ind, y_ind)
                insert_pp(pp)
            else:
                raise RuntimeError(
                    f"incorrect backward pointer {vit_mat} at {ij}")
            if ij[0] < 1 and ij[1] < 1:
                break

        return stack[::-1]

    def _push_gap(self, stack, i, j, matrix, branch_length):
        mp = MatrixPtr(score=-1, x_ind=i, y_ind=j, matrix=matrix)
        cell = (self.X if matrix == X_MAT else self.Y)[i][j]
        mp.fwd_score = cell.fwd_score
        mp.bwd_score = cell.bwd_score
        mp.full_score = cell.full_score
        stack.append(PathPtr(mp, False, branch_length, 1))
