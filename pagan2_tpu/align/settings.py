"""Alignment engine settings (typed replacement of the Settings singleton).

Defaults mirror Basic_alignment::set_basic_settings /
set_reads_alignment_settings / set_additional_settings
(basic_alignment.h:546-629)."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class AlignSettings:
    max_allowed_skip_distance: float = 0.5
    max_allowed_skip_branches: int = 10
    max_allowed_match_skip_branches: int = 5
    branch_skip_weight: float = 1.0
    branch_skip_probability: float = 0.9
    weighted_branch_skip_penalty: bool = False
    weight_edges: bool = False
    compute_full_score: bool = False
    # default on: set_additional_settings flips it on unless
    # --no-reduced-terminal-penalties (basic_alignment.h:627-628)
    reduced_terminal_gap_penalties: bool = True
    no_terminal_edges: bool = False
    edges_for_skipped_flanked_by_gaps: bool = False
    pair_end_reads: bool = False
    # pair-end read1 boundary sites (mark_no_gap_penalty_sites,
    # basic_alignment.h:630-676): set by align_pair after stripping the
    # BREAK_START markers from the input graphs; -1 = no boundary
    x_read1_length: int = -1
    y_read1_length: int = -1
    sample_path: bool = False
    sample_additional_paths: int = 0
    # anchoring (--no-anchors / --use-prefix-anchors; node.cpp:87-152).
    # The reference anchors every pair; we gate by size since tiny
    # matrices are cheaper than anchor discovery.
    use_anchors: bool = True
    use_prefix_anchors: bool = False
    # --hmmer-anchors (find_anchors.cpp:129-223): two 5-length pins at
    # the best local-similarity region's boundaries (native k-mer
    # stand-in for the reference's hmmsearch subprocess)
    use_hmmer_anchors: bool = False
    anchor_min_sites: int = 3000
    prefix_hit_length: int = 30
    anchors_offset: int = 15
    # hit-overlap distance thresholds for anchor acceptance
    # (--ncbi-threshold-overlap-total/-partly, settings.cpp:180-181)
    anchor_threshold_total: int = 50
    anchor_threshold_partly: int = 400
    # edge-weight transform for child->ancestor edge transfer when
    # weight_edges is on: sqrt (default) / plain / cuberoot
    # (viterbi_alignment.cpp:223-227, basic_alignment.h:484-486)
    weight_transform: str = "sqrt"
    # intended semantics of --use-duplicate-weights: weight pileup
    # consensus counts by NumDuplicates=# (basic_alignment.h:165 reads
    # the misspelled "use-duplicate-weigths", so the reference binary
    # never actually fires it; we implement the documented behaviour)
    use_duplicate_weights: bool = False
    # memory budget + force-gap rescue (settings.cpp:187-190,
    # node.cpp:100-152). memory_limit_mb bounds the per-pair DP
    # footprint; with force_gap, anchor-free blocks larger than
    # force_gap_threshold are squeezed to forced gaps until it fits.
    memory_limit_mb: int = 4000
    force_gap: bool = False
    force_gap_threshold: int = 40000
    force_gap_wide_tunnel: bool = False
    # placement-only skip heuristic (node.cpp:155-186): when anchoring
    # leaves more than this fraction of the matrix to compute, skip the
    # alignment entirely (Settings::tunneling_coverage; only activated
    # when a queryfile is present, settings.cpp:392-397)
    anchoring_threshold: float = 1.0
    # --keep-all-edges: apply the permissive reads-alignment skip
    # settings to every alignment, not only read alignments
    # (viterbi_alignment.cpp:206)
    keep_all_edges: bool = False

    def for_reads(self) -> "AlignSettings":
        """set_reads_alignment_settings (basic_alignment.h:572-586)."""
        return replace(self,
                       max_allowed_skip_distance=5.0,
                       max_allowed_skip_branches=50000,
                       max_allowed_match_skip_branches=50000,
                       branch_skip_weight=1.0,
                       branch_skip_probability=1.0)

    def with_reads_anchor_gate(self, gate: int) -> "AlignSettings":
        """Lower the anchoring size gate for read-vs-graph alignments
        (pileup / placement): the reference anchors EVERY pair
        (node.cpp:87-152) and the engine's global anchor_min_sites
        default assumes cheap linear cells, but read-vs-root fills hit
        deep-fan-in cells that cost many times more. Applied only when the
        caller left the default — an explicit user AlignSettings value
        wins over the pipeline's gate."""
        if self.anchor_min_sites == AlignSettings().anchor_min_sites:
            return replace(self, anchor_min_sites=gate)
        return self


# DP matrix ids (basic_alignment.h enum)
X_MAT = 0
Y_MAT = 1
M_MAT = 2

# gap types (viterbi_alignment)
NORMAL_GAP = 0
END_GAP = 1
PAIR_BREAK_GAP = 2
