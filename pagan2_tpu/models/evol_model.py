"""Per-branch-length substitution/indel model bundle.

Equivalent of the reference's Model_factory / Evol_model pair
(src/utils/model_factory.cpp:1871-2229, src/utils/evol_model.h:70-91).
A ModelFactory is built once per data type; ``alignment_model(distance)``
produces the dense score tables for one branch length.

Float-width parity note: the reference computes P(t) in double, rounds
each entry through ``float`` when forming the log-odds score, and stores
the indel/gap probabilities as ``float``.  We reproduce those rounding
points (np.float32 round-trips) so scores match the C++ to the last bit
given identical eigendecompositions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import alphabets as alph
from .eigen import eigen_qrev, p_matrix
from .model_data import hky_q, wag_matrices, ecm_matrices


def _f32(x):
    return np.asarray(x, dtype=np.float32).astype(np.float64)


@dataclass
class IndelParams:
    """Default indel parameters per data type
    (model_factory.cpp:1299-1314, :1480-1497, :1601-1618)."""
    ins_rate: float
    del_rate: float
    gap_ext: float
    end_gap_ext: float
    break_gap_ext: float

    @staticmethod
    def for_data_type(data_type: str, *, pacbio: bool = False) -> "IndelParams":
        if data_type == alph.DNA:
            p = IndelParams(0.01, 0.01, 0.8, 0.95, 0.99)
            if pacbio:
                p.ins_rate = p.del_rate = 1.0
                p.gap_ext = 0.1
            return p
        if data_type == alph.PROTEIN:
            return IndelParams(0.05, 0.05, 0.5, 0.75, 0.0)
        if data_type == alph.CODON:
            return IndelParams(0.01, 0.01, 0.5, 0.75, 0.0)
        raise ValueError(data_type)


@dataclass
class EvolModel:
    """Scores for one branch length. All tables are float64 numpy arrays
    (float32-rounded where the reference rounds)."""
    data_type: str
    distance: float
    score: np.ndarray        # (n_full, n_full) odds-scaled P
    log_score: np.ndarray
    pi: np.ndarray           # (n_canon,)
    log_pi: np.ndarray
    parsimony: np.ndarray    # (n_full, n_full) int32
    child_parsimony: np.ndarray
    mostcommon: np.ndarray
    n_canon: int
    # gap machine parameters (float32-rounded scalars, reference
    # evol_model.h:70-91: gap_open=id_prob, gap_close=1, non_gap=match_prob)
    ins_prob: float
    del_prob: float
    id_prob: float
    match_prob: float
    ext_prob: float
    end_ext_prob: float
    break_ext_prob: float
    log_id_prob: float
    log_match_prob: float
    log_ext_prob: float
    log_end_ext_prob: float
    log_break_ext_prob: float
    ambiguity_type: str = "wildcard"  # or "mostcommon" (--mostcommon)

    # --- accessor parity with Evol_model (evol_model.h:70-91) ---
    def gap_open(self):
        return self.id_prob

    def gap_close(self):
        return 1.0

    def non_gap(self):
        return self.match_prob

    def log_gap_open(self):
        return self.log_id_prob

    def log_gap_close(self):
        return 0.0

    def log_non_gap(self):
        return self.log_match_prob

    def log_gap_ext(self):
        return self.log_ext_prob

    def log_gap_end_ext(self):
        return self.log_end_ext_prob

    def log_gap_break_ext(self):
        return self.log_break_ext_prob

    def is_ambiguity_character(self, i: int) -> bool:
        return i >= self.n_canon

    def parsimony_state(self, i: int, j: int) -> int:
        return int(self.parsimony[i, j])

    def mostcommon_state(self, i: int, j: int) -> int:
        # the protein/codon mostcommon table is canonical-only
        # (model_factory.cpp builds it (n_canon, n_canon); the reference
        # reads out of bounds for ambiguity children — C++ UB). For
        # ambiguity states fall back to the parsimony table instead of
        # crashing (documented deviation).
        n = self.mostcommon.shape[0]
        if i >= n or j >= n:
            return self.parsimony_state(i, j)
        return int(self.mostcommon[i, j])

    def ancestral_state(self, i: int, j: int) -> int:
        if self.ambiguity_type == "mostcommon":
            return self.mostcommon_state(i, j)
        return self.parsimony_state(i, j)


class ModelFactory:
    """Builds EvolModels for a data type. Eigendecomposition happens once;
    each ``alignment_model(d)`` is a dense reconstruction (a matrix
    product when traced under jit via the jax path in ops.substitution)."""

    def __init__(self, data_type: str, *,
                 dna_pi: np.ndarray | None = None,
                 kappa: float = 2.0, rho: float = 1.0,
                 indel: IndelParams | None = None,
                 score_scaling: str = "log-odds",  # "none"|"log-odds"|"raw"
                 ambiguity_factor: float = 1.0,
                 pileup_454: bool = False,
                 mostcommon: bool = False):
        self.data_type = data_type
        self.alphabet = alph.get_alphabet(data_type)
        self.indel = indel or IndelParams.for_data_type(data_type)
        self.score_scaling = score_scaling
        # the reference applies --ambiguity-factor only on the DNA / aa-group
        # paths (model_factory.cpp:1972-1989, :2105-2122); the plain protein
        # and codon pair logic takes a straight max
        groups_active = (data_type == alph.PROTEIN
                         and alph.protein_groups_active())
        # out-of-range factors reset to 1.0 exactly like the reference
        # (model_factory.cpp:1976-1977, :2119-2120)
        if not (0.0 <= ambiguity_factor <= 1.0):
            ambiguity_factor = 1.0
        self.ambiguity_factor = (ambiguity_factor
                                 if data_type == alph.DNA or groups_active
                                 else 1.0)
        self.pileup_454 = pileup_454
        self.mostcommon = mostcommon

        if data_type == alph.DNA:
            if dna_pi is None:
                dna_pi = np.full(4, 0.25)
            pi = np.asarray(dna_pi, dtype=np.float64)
            q = hky_q(pi, kappa, rho)
        elif data_type == alph.PROTEIN:
            pi, q = wag_matrices()
        elif data_type == alph.CODON:
            pi, q = ecm_matrices()
        else:
            raise ValueError(data_type)

        self.pi = pi
        self.q = q
        self.lam, self.u, self.v = eigen_qrev(q, pi)

        a = self.alphabet
        # member-indicator ambiguity weights (model_factory.cpp:1979-1989)
        amb = np.zeros((a.n_canon, a.n_full), dtype=np.float64)
        for j in range(a.n_full):
            w = self.ambiguity_factor ** int(a.n_units[j])
            for k in range(int(a.n_units[j])):
                m = int(a.members[j, k])
                if 0 <= m < a.n_canon:
                    amb[m, j] = w
        # the wildcard state covers every canonical residue (the
        # 51-group alphabet's wildcard is its last group, already
        # covered by the member loop above)
        if data_type != alph.DNA and a.members.shape[1] <= 2:
            amb[:, a.n_canon] = self.ambiguity_factor
        self._amb = amb

    def alignment_model(self, distance: float) -> EvolModel:
        a = self.alphabet
        p = p_matrix(self.lam, self.u, self.v, float(distance))

        # log-odds scaling with float32 rounding of each P entry
        # (model_factory.cpp:1937-1954)
        sp = _f32(p)
        pi = self.pi
        if self.score_scaling == "none":
            lo = _f32(sp / (pi[:, None] * pi[None, :]))
        elif self.score_scaling == "log-odds":
            lo = _f32(0.5 * (pi[:, None] + pi[None, :]) * sp
                      / (pi[:, None] * pi[None, :]))
        else:  # raw P values
            lo = sp

        score = np.full((a.n_full, a.n_full), 0.0, dtype=np.float64)
        score[:a.n_canon, :a.n_canon] = lo

        # ambiguity extension: max-product over constituent residues
        # (model_factory.cpp:1993-2017 DNA; :2155-2220 protein; :2026-2090
        # codon — for two-member pair states all reduce to this max)
        if a.n_full > a.n_canon:
            if self.data_type == alph.DNA or a.members.shape[1] > 2:
                # member-indicator max-product covers DNA IUPAC states
                # and the 51-group aa alphabet (model_factory.cpp:2105-2122)
                amb = self._amb
                # m1[n, j] = max_m lo[n, m] * amb[m, j]
                m1 = np.max(lo[:, :, None] * amb[None, :, :], axis=1)
                # ext[i, j] = max_n m1[n, j] * amb[n, i]
                ext = np.max(m1[:, None, :] * amb[:, :, None], axis=0)
            else:
                # pair states carry at most two members, so the max-product
                # reduces to a max over the <=4 cross pairs; the wildcard
                # row/column is the row/col max of those (reference
                # :2155-2220). Memory stays O(n_full^2).
                nc = a.n_canon
                fi = np.where(a.first_unit < nc, a.first_unit, 0)
                si = np.where(a.second_unit >= 0, a.second_unit, a.first_unit)
                si = np.where(si < nc, si, 0)
                ext = np.maximum.reduce([
                    lo[np.ix_(fi, fi)], lo[np.ix_(fi, si)],
                    lo[np.ix_(si, fi)], lo[np.ix_(si, si)]])
                # wildcard vs j: max over canonical n of ext(n, j)
                wild_col = ext[:nc, :].max(axis=0)
                wild_row = ext[:, :nc].max(axis=1)
                ext[nc, :] = wild_col
                ext[:, nc] = wild_row
                ext[nc, nc] = lo.max()
            canon = np.zeros(a.n_full, dtype=bool)
            canon[:a.n_canon] = True
            both_canon = canon[:, None] & canon[None, :]
            score = np.where(both_canon, score, ext)

        with np.errstate(divide="ignore"):
            log_score = np.log(score)

        ind = self.indel
        ins_rate, del_rate = ind.ins_rate, ind.del_rate
        if self.pileup_454:
            # pileup with 454/homopolymer error model
            # (model_factory.cpp:1901-1905)
            ins_rate = del_rate = 0.25

        d = float(distance)
        ins_prob = _f32(1.0 - np.exp(-ins_rate * d))
        del_prob = _f32(1.0 - np.exp(-del_rate * d))
        t = 1.0 - np.exp(-0.5 * (ins_rate + del_rate) * d)
        id_prob = _f32(t)
        match_prob = _f32(1.0 - 2.0 * t)
        log_id_prob = _f32(np.log(t))
        log_match_prob = _f32(np.log(1.0 - 2.0 * t))

        return EvolModel(
            data_type=self.data_type,
            distance=d,
            score=score,
            log_score=log_score,
            pi=pi.copy(),
            log_pi=np.log(pi),
            parsimony=a.parsimony,
            child_parsimony=a.child_parsimony,
            mostcommon=a.mostcommon,
            n_canon=a.n_canon,
            ins_prob=float(ins_prob),
            del_prob=float(del_prob),
            id_prob=float(id_prob),
            match_prob=float(match_prob),
            ext_prob=float(_f32(ind.gap_ext)),
            end_ext_prob=float(_f32(ind.end_gap_ext)),
            break_ext_prob=float(_f32(ind.break_gap_ext)),
            log_id_prob=float(log_id_prob),
            log_match_prob=float(log_match_prob),
            log_ext_prob=float(_f32(np.log(ind.gap_ext))),
            log_end_ext_prob=float(_f32(np.log(ind.end_gap_ext))),
            log_break_ext_prob=float(
                _f32(np.log(ind.break_gap_ext)) if ind.break_gap_ext > 0
                else -np.inf),
            ambiguity_type="mostcommon" if self.mostcommon else "wildcard",
        )
