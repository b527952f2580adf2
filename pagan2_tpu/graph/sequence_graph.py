"""Partial-order sequence graphs as structure-of-arrays.

Array data model equivalent of the reference's Sequence/Site/Edge
(src/main/sequence.h:28-1004). Sites live in index order start..stop;
edges are kept in one growing SoA with per-site *ordered* adjacency lists
(insertion order is semantically meaningful: the DP's tie-breaking visits
edges in first-inserted-first order, mirroring the reference's intrusive
linked lists, sequence.h:340-432).

``padded_bwd_arrays`` exports the graph as fixed-width device arrays
(prev-site index, log-weight, edge id, mask) for the vectorized DP.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# site_type (sequence.h:226)
START_SITE = 0
REAL_SITE = 1
STOP_SITE = 2
BREAK_START_SITE = 3
BREAK_STOP_SITE = 4
NON_REAL = 5

# path_state (sequence.h:229)
ENDS_SITE = 0
TERMINAL = 1
MATCHED = 2
XGAPPED = 3
YGAPPED = 4
XSKIPPED = 5
YSKIPPED = 6


@dataclass
class _Edges:
    """Growable SoA of edges (sequence.h:34-127)."""
    start: list = field(default_factory=list)
    end: list = field(default_factory=list)
    weight: list = field(default_factory=list)
    used: list = field(default_factory=list)
    bcount_slu: list = field(default_factory=list)   # branch_count_since_last_used
    bdist_slu: list = field(default_factory=list)    # branch_distance_since_last_used
    bcount_skip: list = field(default_factory=list)  # branch_count_as_skipped_edge

    def add(self, s: int, e: int, w: float = 1.0) -> int:
        self.start.append(s)
        self.end.append(e)
        self.weight.append(np.float32(w))
        self.used.append(False)
        self.bcount_slu.append(0)
        self.bdist_slu.append(np.float32(0.0))
        self.bcount_skip.append(0)
        return len(self.start) - 1

    def __len__(self):
        return len(self.start)


class SequenceGraph:
    """A character-presence graph over sites with weighted edges."""

    def __init__(self, data_type: str, gap_symbol: str = "-"):
        self.data_type = data_type
        self.gap_symbol = gap_symbol
        # site SoA
        self.states: list[int] = []
        self.symbols: list[str] = []
        self.site_type: list[int] = []
        self.path_state: list[int] = []
        self.posterior_support: list[float] = []
        self.site_bcount_slu: list[int] = []
        self.site_bdist_slu: list[float] = []
        self.child_l: list[int] = []
        self.child_r: list[int] = []
        self.sumA: list[int] = []
        self.sumC: list[int] = []
        self.sumG: list[int] = []
        self.sumT: list[int] = []
        self.ambiguous: list[bool] = []
        # edges
        self.edges = _Edges()
        self.bwd: list[list[int]] = []   # ordered bwd edge ids per site
        self.fwd: list[list[int]] = []   # ordered fwd edge ids per site
        # metadata
        self.is_read_sequence = False
        self.has_read_descendants = False
        self.num_duplicates = 1
        self.terminal_sequence = True
        # full aligned row (with gaps) when built from / for a reference
        # alignment (Sequence::gapped_seq, sequence.h:816)
        self.gapped_seq: str | None = None

    # ------------------------------------------------------------------
    def num_sites(self) -> int:
        return len(self.states)

    sites_length = num_sites

    def add_site(self, state: int, symbol: str = "0",
                 site_type: int = REAL_SITE, path_state: int = TERMINAL,
                 support: float = 1.0, child_l: int = -1, child_r: int = -1,
                 ambiguous: bool = False) -> int:
        self.states.append(state)
        self.symbols.append(symbol)
        self.site_type.append(site_type)
        self.path_state.append(path_state)
        self.posterior_support.append(support)
        self.site_bcount_slu.append(0)
        self.site_bdist_slu.append(0.0)
        self.child_l.append(child_l)
        self.child_r.append(child_r)
        self.sumA.append(0)
        self.sumC.append(0)
        self.sumG.append(0)
        self.sumT.append(0)
        self.ambiguous.append(ambiguous)
        self.bwd.append([])
        self.fwd.append([])
        return len(self.states) - 1

    def add_edge(self, s: int, e: int, w: float = 1.0) -> int:
        eid = self.edges.add(s, e, w)
        if s >= 0:
            self.fwd[s].append(eid)
        if e >= 0 and e < len(self.bwd):
            self.bwd[e].append(eid)
        return eid

    def add_chain_sites_bulk(self, states, symbols):
        """Append a run of REAL/TERMINAL sites, each chained to its
        predecessor by a weight-1 edge — the plain linear-chain leaf
        fast path (per-site add_site/add_edge Python calls dominate
        megabase host prep otherwise). Equivalent to
        [add_site(st, sym) + add_edge(prev, cur)] per character."""
        n = len(states)
        if n == 0:
            return
        base = len(self.states)
        self.states.extend(states)
        self.symbols.extend(symbols)
        self.site_type.extend([REAL_SITE] * n)
        self.path_state.extend([TERMINAL] * n)
        self.posterior_support.extend([1.0] * n)
        self.site_bcount_slu.extend([0] * n)
        self.site_bdist_slu.extend([0.0] * n)
        self.child_l.extend([-1] * n)
        self.child_r.extend([-1] * n)
        self.sumA.extend([0] * n)
        self.sumC.extend([0] * n)
        self.sumG.extend([0] * n)
        self.sumT.extend([0] * n)
        self.ambiguous.extend([False] * n)
        e0 = len(self.edges.start)
        self.edges.start.extend(range(base - 1, base + n - 1))
        self.edges.end.extend(range(base, base + n))
        w1 = np.float32(1.0)
        z0 = np.float32(0.0)
        self.edges.weight.extend([w1] * n)
        self.edges.used.extend([False] * n)
        self.edges.bcount_slu.extend([0] * n)
        self.edges.bdist_slu.extend([z0] * n)
        self.edges.bcount_skip.extend([0] * n)
        if base > 0:
            self.fwd[base - 1].append(e0)
        self.fwd.extend([[e0 + k + 1] for k in range(n - 1)])
        self.fwd.append([])
        self.bwd.extend([[e0 + k] for k in range(n)])

    # --- edge queries mirroring Site::contains_bwd_edge etc. -----------
    def find_bwd_edge(self, end_site: int, start_site: int) -> int:
        """First bwd edge at `end_site` with the given start, else -1."""
        for eid in self.bwd[end_site]:
            if self.edges.start[eid] == start_site:
                return eid
        return -1

    def find_fwd_edge(self, start_site: int, end_site: int) -> int:
        for eid in self.fwd[start_site]:
            if self.edges.end[eid] == end_site:
                return eid
        return -1

    def first_bwd_start(self, site: int) -> int:
        """Start index of the first (linear) bwd edge of `site`."""
        return self.edges.start[self.bwd[site][0]]

    def delete_all_edges_at_site(self, site: int):
        """Detach a site (Basic_alignment::delete_edge_range helper,
        basic_alignment.cpp:491-508): remove its edges from both
        adjacency sides."""
        for eid in list(self.bwd[site]):
            s = self.edges.start[eid]
            if eid in self.fwd[s]:
                self.fwd[s].remove(eid)
        self.bwd[site] = []
        for eid in list(self.fwd[site]):
            e = self.edges.end[eid]
            if eid in self.bwd[e]:
                self.bwd[e].remove(eid)
        self.fwd[site] = []

    # ------------------------------------------------------------------
    def check_valid_graph(self) -> bool:
        """Graph invariant from Node::check_valid_graph
        (node.cpp:1413-1469): every fwd edge appears as a bwd edge of its
        end site and vice versa."""
        for i in range(self.num_sites()):
            for eid in self.fwd[i]:
                if self.edges.start[eid] != i:
                    return False
                if eid not in self.bwd[self.edges.end[eid]]:
                    return False
            for eid in self.bwd[i]:
                if self.edges.end[eid] != i:
                    return False
                if self.edges.start[eid] < 0:
                    continue  # the dangling first edge (-1 -> 0)
                if eid not in self.fwd[self.edges.start[eid]]:
                    return False
        return True

    # ------------------------------------------------------------------
    def max_bwd_fanin(self) -> int:
        return max((len(b) for b in self.bwd), default=0)

    def padded_bwd_arrays(self, k_max: int | None = None):
        """Fixed-width arrays for the vectorized DP.

        Returns dict with, for every site i (0..N-1):
          prev[i, k]   : start index of k-th bwd edge (or 0 if invalid)
          logw[i, k]   : log posterior weight (float64, from the float32
                         weight like the reference's Edge)
          w[i, k]      : posterior weight
          eid[i, k]    : edge id into the SoA (-1 invalid)
          mask[i, k]   : validity
        """
        n = self.num_sites()
        k = k_max or max(1, self.max_bwd_fanin())
        prev = np.zeros((n, k), dtype=np.int32)
        w = np.zeros((n, k), dtype=np.float64)
        logw = np.full((n, k), -np.inf, dtype=np.float64)
        eid = np.full((n, k), -1, dtype=np.int32)
        mask = np.zeros((n, k), dtype=bool)
        for i in range(n):
            for kk, e in enumerate(self.bwd[i][:k]):
                prev[i, kk] = self.edges.start[e]
                wt = float(self.edges.weight[e])
                w[i, kk] = wt
                # Edge stores log_posterior_weight as float32 of log(w)
                logw[i, kk] = float(np.float32(np.log(wt))) if wt > 0 else -np.inf
                eid[i, kk] = e
                mask[i, kk] = True
            if len(self.bwd[i]) > k:
                raise ValueError(
                    f"site {i} has fan-in {len(self.bwd[i])} > k_max {k}")
        return dict(prev=prev, w=w, logw=logw, eid=eid, mask=mask)

    # ------------------------------------------------------------------
    def print_sequence(self) -> str:
        out = []
        for i in range(self.num_sites()):
            es = ["(%d->%d w=%.3g%s)" % (
                self.edges.start[e], self.edges.end[e], self.edges.weight[e],
                "*" if self.edges.used[e] else "")
                for e in self.bwd[i]]
            out.append(f"{i} '{self.symbols[i]}' st={self.states[i]} "
                       f"t={self.site_type[i]} p={self.path_state[i]} "
                       f"bwd={' '.join(es)}")
        return "\n".join(out)

    def unaligned_symbols(self) -> list[str]:
        return [self.symbols[i] for i in range(1, self.num_sites() - 1)
                if self.site_type[i] != NON_REAL]
