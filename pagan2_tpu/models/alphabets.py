"""Alphabets and parsimony tables for DNA / protein / codon data.

Reimplementation of the alphabet layer of PAGAN2
(reference: src/utils/model_factory.cpp:120-299 for DNA,
:304-665 for protein, :839-1100 for codons). All tables are dense
numpy arrays so they can be shipped to device as gather tables.

State encoding follows the reference exactly:
  DNA:      15 states  "ACGTRYMKWSBDHVN"  (4 canonical + 11 IUPAC)
  protein:  211 states "ARNDCQEGHILKMFPSTWYV" + X + 190 unordered pairs
  codon:    1892 states: 61 sense codons + NNN + 1830 unordered pairs
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

DNA = "dna"
PROTEIN = "protein"
CODON = "codon"

DNA_CHARS = "ACGT"
DNA_FULL_CHARS = "ACGTRYMKWSBDHVN"
PROTEIN_CHARS = "ARNDCQEGHILKMFPSTWYV"

# 61 sense codons in the reference's fixed order (alphabetical, stops removed)
# reference: model_factory.cpp:841
_BASES = "ACGT"
_STOPS = {"TAA", "TAG", "TGA"}
CODONS = [a + b + c for a in _BASES for b in _BASES for c in _BASES
          if a + b + c not in _STOPS]
assert len(CODONS) == 61


@dataclass
class Alphabet:
    """A resolved alphabet: canonical size, full (ambiguity-extended) size,
    symbol list, and parsimony tables.

    Attributes
    ----------
    n_canon : number of canonical states (4 / 20 / 61)
    n_full  : number of full states incl. ambiguity codes
    symbols : list of display strings, one per full state
    n_units : number of canonical residues each full state stands for
    members : (n_full, max_units) int array of canonical residue indices
              padded with -1
    parsimony : (n_full, n_full) int table — the ancestral state assigned
              to a parent whose children carry states (i, j)
    child_parsimony : (n_full, n_full) int table used when pushing a
              resolved parent state back down to children
    mostcommon : int table (DNA: same as parsimony; protein/codon:
              (n_canon, n_canon) argmax-pi winner)
    """
    name: str
    n_canon: int
    n_full: int
    symbols: list[str]
    n_units: np.ndarray
    members: np.ndarray
    parsimony: np.ndarray
    child_parsimony: np.ndarray
    mostcommon: np.ndarray
    # index of first/second canonical member for 2-unit pair states; -1 else
    first_unit: np.ndarray = field(default=None)
    second_unit: np.ndarray = field(default=None)
    char_to_state: dict = field(default_factory=dict)

    @property
    def gap_symbol(self) -> str:
        return "---" if self.name == CODON else "-"

    def state_of(self, symbol: str) -> int:
        """State index for a symbol; exact case first (the 51-group
        alphabet's group states are lowercase letters/digits), then
        case-folded (lowercase DNA/protein input)."""
        st = self.char_to_state.get(symbol)
        if st is None:
            st = self.char_to_state.get(symbol.upper(), -1)
        return st


def _pair_index(n_canon: int, i: int, j: int) -> int:
    """Full-state index of the unordered canonical pair {i<j}: the pairs are
    enumerated row-major over the upper triangle after the n_canon singles
    and the one wildcard state (reference: model_factory.cpp:344-363,
    :879-896, and the closed form at :1009-1024)."""
    c1, c2 = min(i, j), max(i, j)
    base = n_canon + 1
    # rows 0..c1-1 contribute (n_canon-1), (n_canon-2), ...
    off = c1 * (n_canon - 1) - (c1 * (c1 - 1)) // 2
    return base + off + (c2 - c1 - 1)


@functools.lru_cache(maxsize=None)
def dna_alphabet() -> Alphabet:
    """DNA-15 with bitwise IUPAC parsimony (model_factory.cpp:120-299)."""
    ambi = ["A", "C", "G", "T", "AG", "CT", "AC", "GT", "AT", "CG",
            "CGT", "AGT", "ACT", "ACG", "ACGT"]
    n_full = 15
    bits = np.zeros(n_full, dtype=np.int64)
    for i, s in enumerate(ambi):
        for ch in s:
            bits[i] |= 1 << DNA_CHARS.index(ch)
    bit_to_state = {int(b): i for i, b in enumerate(bits)}

    parsimony = np.zeros((n_full, n_full), dtype=np.int32)
    for i in range(n_full):
        for j in range(n_full):
            v = bits[i] & bits[j]
            parsimony[i, j] = bit_to_state[int(v if v > 0 else bits[i] | bits[j])]

    child_parsimony = np.zeros_like(parsimony)
    for i in range(n_full):
        for j in range(n_full):
            if bits[i] & bits[j] > 0:
                child_parsimony[i, j] = parsimony[i, j]
            else:
                child_parsimony[i, j] = j

    max_units = 4
    members = np.full((n_full, max_units), -1, dtype=np.int32)
    n_units = np.zeros(n_full, dtype=np.int32)
    for i, s in enumerate(ambi):
        n_units[i] = len(s)
        for k, ch in enumerate(s):
            members[i, k] = DNA_CHARS.index(ch)

    return Alphabet(
        name=DNA, n_canon=4, n_full=n_full,
        symbols=list(DNA_FULL_CHARS),
        n_units=n_units, members=members,
        parsimony=parsimony, child_parsimony=child_parsimony,
        mostcommon=parsimony.copy(),
        first_unit=members[:, 0].copy(),
        second_unit=members[:, 1].copy(),
        char_to_state={c: i for i, c in enumerate(DNA_FULL_CHARS)},
    )


def _paired_alphabet(n_canon: int, singles: list[str], wildcard: str,
                     pi: np.ndarray, q: np.ndarray, name: str) -> Alphabet:
    """Shared construction for protein (X + pairs) and codon (NNN + pairs)
    alphabets (model_factory.cpp:304-665, :839-1100)."""
    symbols = list(singles) + [wildcard]
    first = list(range(n_canon)) + [n_canon]
    second = [-1] * (n_canon + 1)
    for i in range(n_canon - 1):
        for j in range(i + 1, n_canon):
            symbols.append(singles[i] + "|" + singles[j])
            first.append(i)
            second.append(j)
    n_full = len(symbols)
    first = np.array(first, dtype=np.int32)
    second = np.array(second, dtype=np.int32)

    n_units = np.where(second >= 0, 2, 1).astype(np.int32)
    n_units[n_canon] = 1  # wildcard is formally n_units=1 in pair logic
    members = np.full((n_full, 2), -1, dtype=np.int32)
    members[:, 0] = first
    members[:, 1] = second

    # pair-state lookup for canonical (i, j)
    pair_of = np.zeros((n_canon, n_canon), dtype=np.int32)
    for i in range(n_canon):
        for j in range(n_canon):
            pair_of[i, j] = i if i == j else _pair_index(n_canon, i, j)

    # --- vectorised parsimony table -------------------------------------
    FI, FJ = np.meshgrid(first, first, indexing="ij")
    SI, SJ = np.meshgrid(second, second, indexing="ij")
    UI, UJ = np.meshgrid(n_units, n_units, indexing="ij")
    II, JJ = np.meshgrid(np.arange(n_full, dtype=np.int32),
                         np.arange(n_full, dtype=np.int32), indexing="ij")

    si_safe = np.where(SI >= 0, SI, 0)
    sj_safe = np.where(SJ >= 0, SJ, 0)
    fi_safe = np.where(FI < n_canon, FI, 0)  # wildcard rows are overridden
    fj_safe = np.where(FJ < n_canon, FJ, 0)  # by earlier select branches

    # max-Q candidate search over the <=4 cross pairs, in the reference's
    # scan order (first strictly-greater wins)
    neg = -np.inf
    q00 = q[fi_safe, fj_safe]
    q01 = np.where(UJ == 2, q[fi_safe, sj_safe], neg)
    q10 = np.where(UI == 2, q[si_safe, fj_safe], neg)
    q11 = np.where((UI == 2) & (UJ == 2), q[si_safe, sj_safe], neg)
    stackq = np.stack([q00, q01, q10, q11])
    best = np.argmax(stackq, axis=0)  # first max wins, matching strict >
    best_m = np.choose(best, [fi_safe, fi_safe, si_safe, si_safe])
    best_n = np.choose(best, [fj_safe, sj_safe, fj_safe, sj_safe])
    maxq_state = pair_of[best_m, best_n]

    overlap_ij = (FI == FJ) | (FI == SJ)   # fi in members(j)
    overlap_ji = (FJ == FI) | (FJ == SI)   # fj in members(i)

    parsimony = np.select(
        [II == JJ,
         FI == n_canon,
         FJ == n_canon,
         (UI == 1) & (UJ == 1),
         (UI == 1) & (UJ == 2) & overlap_ij,
         (UJ == 1) & (UI == 2) & overlap_ji],
        [II, JJ, II, pair_of[fi_safe, fj_safe], FI, FJ],
        default=0)
    fallthrough = ~((II == JJ) | (FI == n_canon) | (FJ == n_canon)
                    | ((UI == 1) & (UJ == 1))
                    | ((UI == 1) & (UJ == 2) & overlap_ij)
                    | ((UJ == 1) & (UI == 2) & overlap_ji))
    parsimony = np.where(fallthrough, maxq_state, parsimony).astype(np.int32)

    # --- vectorised child-parsimony table -------------------------------
    c_val = np.where((FI == FJ) | (FI == SJ), FI,
                     np.where((SI == FJ) | (SI == SJ), si_safe, -1))
    pair_branch = np.where(c_val >= 0, c_val, JJ)
    child_parsimony = np.select(
        [(II == JJ) | (FI == n_canon),
         FJ == n_canon,
         UJ == 1,
         UI == 1],
        [JJ, II, JJ, np.where(overlap_ij, II, JJ)],
        default=0)
    both_pairs = ~((II == JJ) | (FI == n_canon) | (FJ == n_canon)
                   | (UJ == 1) | (UI == 1))
    child_parsimony = np.where(both_pairs, pair_branch,
                               child_parsimony).astype(np.int32)

    mostcommon = np.zeros((n_canon, n_canon), dtype=np.int32)
    for i in range(n_canon):
        for j in range(n_canon):
            mostcommon[i, j] = i if pi[i] > pi[j] else j

    char_to_state = {s: i for i, s in enumerate(symbols[:n_canon + 1])}

    return Alphabet(
        name=name, n_canon=n_canon, n_full=n_full, symbols=symbols,
        n_units=n_units, members=members,
        parsimony=parsimony, child_parsimony=child_parsimony,
        mostcommon=mostcommon, first_unit=first, second_unit=second,
        char_to_state=char_to_state,
    )


@functools.lru_cache(maxsize=None)
def protein_alphabet() -> Alphabet:
    from .model_data import wag_matrices
    pi, q = wag_matrices()
    return _paired_alphabet(20, list(PROTEIN_CHARS), "X", pi, q, PROTEIN)


# --use-aa-groups residue groups (model_factory.cpp:678-683): the 31
# fixed multi-residue ambiguity classes appended to the 20 amino acids;
# index 50 doubles as the X wildcard (all residues).
PROTEIN_GROUPS = [
    "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I", "L", "K", "M",
    "F", "P", "S", "T", "W", "Y", "V",
    "NG", "HA", "IV", "ST", "QE", "ML", "RK", "ED", "CV", "FY", "RKQ",
    "AST", "HML", "NED", "TIV", "MLF", "CIV", "LFY", "IML", "NAST",
    "HRKQ", "ASTG", "MLFY", "LFYW", "RKHSA", "HRKQSTA", "HRKQNEDSTA",
    "HRKQNEDSTPA", "HRKQNEDSTGPA", "HRKQNEDSTGPACVIM",
    "HRKQNEDSTGPACVIMLFYW",
]
PROTEIN_GROUP_CHARS = "ARNDCQEGHILKMFPSTWYVabcdefghijklmnopqrstuvxyz12345X"


@functools.lru_cache(maxsize=None)
def protein_groups_alphabet() -> Alphabet:
    """--use-aa-groups: 51-state protein parsimony alphabet whose
    ambiguity states are fixed residue groups
    (model_factory.cpp:670-838, define_protein_alphabet_groups).

    The reference hardcodes the 51x51 parsimony table; here it is
    derived from the group definitions themselves: when one state's
    residue set contains the other's, the parent is the contained
    (smaller) state; otherwise it is the smallest group containing
    members(i) | members(j), lowest index winning ties — which
    reproduces the reference's 51x51 literal exactly (full-table
    equality asserted in tests).
    child_parsimony keeps the child state unless every parent residue
    is included in the child's group (model_factory.cpp:757-785)."""
    n_canon = 20
    n_full = len(PROTEIN_GROUPS)
    groups = [frozenset(g) for g in PROTEIN_GROUPS]
    order = sorted(range(n_full), key=lambda k: (len(groups[k]), k))

    def smallest_containing(s: frozenset) -> int:
        for k in order:
            if s <= groups[k]:
                return k
        raise AssertionError("group cover missing")  # 50 covers all

    parsimony = np.zeros((n_full, n_full), dtype=np.int32)
    child_parsimony = np.zeros_like(parsimony)
    for i in range(n_full):
        for j in range(n_full):
            if groups[i] <= groups[j]:
                parsimony[i, j] = smallest_containing(groups[i])
            elif groups[j] <= groups[i]:
                parsimony[i, j] = smallest_containing(groups[j])
            else:
                parsimony[i, j] = smallest_containing(groups[i] |
                                                      groups[j])
            child_parsimony[i, j] = (parsimony[i, j]
                                     if groups[i] <= groups[j] else j)

    n_units = np.array([len(g) for g in PROTEIN_GROUPS], dtype=np.int32)
    members = np.full((n_full, int(n_units.max())), -1, dtype=np.int32)
    for i, g in enumerate(PROTEIN_GROUPS):
        for k, c in enumerate(g):
            members[i, k] = PROTEIN_CHARS.index(c)

    return Alphabet(
        name=PROTEIN, n_canon=n_canon, n_full=n_full,
        symbols=list(PROTEIN_GROUP_CHARS),
        n_units=n_units, members=members,
        parsimony=parsimony, child_parsimony=child_parsimony,
        mostcommon=parsimony.copy(),
        first_unit=members[:, 0].copy(), second_unit=members[:, 1].copy(),
        char_to_state={c: i for i, c in enumerate(PROTEIN_GROUP_CHARS)},
    )


# --use-aa-groups switch (global like the reference's Settings_handle;
# set once by the CLI before any model/graph construction)
_USE_AA_GROUPS = False


def set_protein_groups(on: bool):
    global _USE_AA_GROUPS
    _USE_AA_GROUPS = bool(on)


def protein_groups_active() -> bool:
    return _USE_AA_GROUPS


@functools.lru_cache(maxsize=None)
def codon_alphabet() -> Alphabet:
    from .model_data import ecm_matrices
    pi, q = ecm_matrices()
    alpha = _paired_alphabet(61, CODONS, "NNN", pi, q, CODON)
    return alpha


def get_alphabet(name: str) -> Alphabet:
    if name == DNA:
        return dna_alphabet()
    if name == PROTEIN:
        if _USE_AA_GROUPS:
            return protein_groups_alphabet()
        return protein_alphabet()
    if name == CODON:
        return codon_alphabet()
    raise ValueError(f"unknown alphabet {name!r}")


# Ancestral display alphabets (reference: model_factory.cpp:1469-1472,
# :1581-1594, :1739-1746): the symbol printed for an ancestral state.
def ancestral_symbols(name: str) -> list[str]:
    if name == DNA:
        return list(DNA_FULL_CHARS)
    if name == PROTEIN:
        if _USE_AA_GROUPS:
            # group states render as their own symbols
            # (full_char_alphabet, model_factory.cpp:673)
            return list(PROTEIN_GROUP_CHARS)
        from .model_data import wag_matrices
        pi, _ = wag_matrices()
        out = list(PROTEIN_CHARS) + ["X"]
        for i in range(19):
            for j in range(i + 1, 20):
                out.append(PROTEIN_CHARS[i] if pi[i] > pi[j] else PROTEIN_CHARS[j])
        return out
    if name == CODON:
        # the reference ships only the 62 singles (model_factory.cpp:1743-46,
        # pair expansion commented out); we extend pair states with the
        # higher-pi member so ancestral codon states always render
        from .model_data import ecm_matrices
        pi, _ = ecm_matrices()
        out = CODONS + ["NNN"]
        for i in range(60):
            for j in range(i + 1, 61):
                out.append(CODONS[i] if pi[i] > pi[j] else CODONS[j])
        return out
    raise ValueError(name)
