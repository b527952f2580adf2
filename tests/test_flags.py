"""Tests for the flag-parity batch: weight transforms, memory budget +
force-gap, anchoring-threshold skip, guided (TID) placement, assembly
mode, contig/consensus reconstruction, plot writers, align-reads-at-root
and the full reference flag surface."""
import os

import numpy as np
import pytest

from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph
from pagan2_tpu.align import align_pair, AlignSettings
from pagan2_tpu.io.fasta import FastaEntry
from pagan2_tpu.tree.newick import parse_newick


def _random_pair(rng, n, sub=0.1):
    base = rng.choice(list("ACGT"), size=n)
    s1 = "".join(base)
    s2 = "".join(c if rng.random() > sub else rng.choice(list("ACGT"))
                 for c in base)
    return s1, s2


def test_cli_accepts_every_reference_flag():
    """The parser must accept the reference's full settings.cpp flag
    list (settings.cpp:40-302)."""
    import re
    from pagan2_tpu.cli import build_parser
    ref_src = None
    for cand in ("/root/reference/src/utils/settings.cpp",):
        if os.path.exists(cand):
            ref_src = open(cand).read()
    if ref_src is None:
        pytest.skip("reference not available")
    flags = set(re.findall(r'\("([a-z0-9][a-zA-Z0-9-]+)"[,)]', ref_src))
    parser = build_parser()
    known = set()
    for action in parser._actions:
        for opt in action.option_strings:
            known.add(opt.lstrip("-").lower())
    # positional config-file; help/full-help are argparse-native
    known |= {"config-file", "help", "full-help"}
    missing = sorted(f for f in flags if f.lower() not in known)
    assert missing == [], missing


def test_weight_transforms_change_edge_weight():
    from pagan2_tpu.align.ancestral import build_ancestral_graph
    from pagan2_tpu.align.oracle import PairAligner
    from dataclasses import replace
    rng = np.random.default_rng(0)
    s1, s2 = _random_pair(rng, 30)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    base = AlignSettings(weight_edges=True, compute_full_score=True)
    weights = {}
    for wt in ("sqrt", "plain", "cuberoot"):
        s = replace(base, weight_transform=wt)
        g1 = build_leaf_graph(s1, alph.DNA)
        g2 = build_leaf_graph(s2, alph.DNA)
        al = PairAligner(g1, g2, model, s)
        path, _ = al.align()
        anc = build_ancestral_graph(g1, g2, path, model, s, 0.1, 0.1)
        weights[wt] = np.array(anc.edges.weight, dtype=float)
    # posterior supports in (0,1): sqrt > cuberoot ordering flips vs
    # plain depending on w<1; just require they differ somewhere
    assert not np.allclose(weights["sqrt"], weights["plain"])
    assert not np.allclose(weights["sqrt"], weights["cuberoot"])


def test_memory_limit_raises_without_force_gap():
    from dataclasses import replace
    rng = np.random.default_rng(1)
    # unrelated sequences -> no anchors -> full-cost band
    s1 = "".join(rng.choice(list("ACGT"), size=4000))
    s2 = "".join(rng.choice(list("ACGT"), size=4000))
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    s = AlignSettings(memory_limit_mb=50, anchor_min_sites=1000)
    with pytest.raises(MemoryError):
        align_pair(g1, g2, model, s, engine="jax")


def test_anchoring_threshold_skips_alignment():
    rng = np.random.default_rng(2)
    s1 = "".join(rng.choice(list("ACGT"), size=4000))
    s2 = "".join(rng.choice(list("ACGT"), size=4000))
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    # unrelated pair -> coverage ~1 > 0.5 -> skip
    s = AlignSettings(anchoring_threshold=0.5, anchor_min_sites=1000)
    anc, end = align_pair(g1, g2, model, s, engine="jax")
    assert anc is None and end is None


def test_force_gap_reduces_memory_or_errors():
    rng = np.random.default_rng(3)
    # two anchored blocks with a large unrelated middle
    a, _ = _random_pair(rng, 1500, 0.0)
    mid1 = "".join(rng.choice(list("ACGT"), size=1500))
    mid2 = "".join(rng.choice(list("ACGT"), size=1500))
    b, _ = _random_pair(rng, 1500, 0.0)
    s1 = a + mid1 + b
    s2 = a + mid2 + b
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.2)
    s = AlignSettings(memory_limit_mb=60, force_gap=True,
                      force_gap_threshold=10000, anchor_min_sites=1000)
    anc, end = align_pair(g1, g2, model, s, engine="jax")
    assert anc is not None and anc.num_sites() > 3000


def test_guided_placement_uses_tid_tags():
    from pagan2_tpu.pipeline.refread import read_reference_alignment
    from pagan2_tpu.pipeline.placement import (place_queries,
                                               PlacementConfig)
    entries = [FastaEntry(name="a", sequence="ACGTACGTAA"),
               FastaEntry(name="b", sequence="ACGTACGTAA"),
               FastaEntry(name="c", sequence="TTTTGGGGCC")]
    tree = "((a:0.1,b:0.1)[&&NHX:TID=1]:0.1,c:0.2);"
    res = read_reference_alignment(entries, tree, data_type=alph.DNA)
    queries = [FastaEntry(name="q1", sequence="ACGTACGTAA",
                          comment="TID=1")]
    cfg = PlacementConfig(guided=True, min_query_overlap=0.4,
                          min_query_identity=0.4)
    out = place_queries(res, queries, alph.DNA, cfg)
    assert out.placed, "guided query should place at the tagged node"


def test_assembly_places_at_root_only():
    from pagan2_tpu.pipeline.refread import read_reference_alignment
    from pagan2_tpu.pipeline.placement import (place_queries,
                                               PlacementConfig,
                                               _candidate_names)
    entries = [FastaEntry(name="a", sequence="ACGTACGTAA"),
               FastaEntry(name="b", sequence="ACGTACGTAA")]
    res = read_reference_alignment(entries, "(a:0.1,b:0.1);",
                                   data_type=alph.DNA)
    cfg = PlacementConfig(assembly=True)
    assert _candidate_names(res.tree, cfg) == [res.tree.name]


def test_reconstruct_contigs_pileup():
    from pagan2_tpu.pipeline.pileup import (pileup_align, PileupConfig,
                                            reconstruct_contigs)
    rng = np.random.default_rng(5)
    base = "".join(rng.choice(list("ACGT"), size=300))
    reads = [FastaEntry(name="r%d" % i, sequence=base[i * 30:i * 30 + 180])
             for i in range(4)]
    cfg = PileupConfig(use_consensus=True, consensus_minimum=1,
                       consensus_minimum_proportion=0.1)
    res = pileup_align(reads, alph.DNA, cfg)
    rows = reconstruct_contigs(res.root, cfg, consensus_only=True)
    assert rows and rows[0].name.startswith("consensus_")
    assert set(rows[0].sequence) <= set("ACGTRYMKWSBDHVN-acgtn")


def test_mpost_and_r_plot_writers(tmp_path):
    from pagan2_tpu.pipeline.progressive import align_progressive
    from pagan2_tpu.io.plots import write_mpost_sequence_graphs
    entries = [FastaEntry(name="a", sequence="ACGTACGT"),
               FastaEntry(name="b", sequence="ACGAACGT")]
    tree = parse_newick("(a:0.1,b:0.1);")
    res = align_progressive(entries, tree, data_type=alph.DNA)
    mp = tmp_path / "g.mp"
    write_mpost_sequence_graphs(res.tree, str(mp), include_leaves=True)
    text = mp.read_text()
    assert "beginfig(1)" in text and "endfig" in text and "circle" in text

    from pagan2_tpu.align.anchors import (find_kmer_anchors,
                                          define_tunnel)
    from pagan2_tpu.io.plots import write_anchors_for_R
    rng = np.random.default_rng(6)
    s1, s2 = _random_pair(rng, 500, 0.02)
    hits = find_kmer_anchors(s1, s2)
    upper, lower, _ = define_tunnel(hits, s1, s2, 15)
    rp = tmp_path / "anc.r"
    write_anchors_for_R(hits, upper, lower, str(rp))
    rtext = rp.read_text()
    assert "anc_x1 <- c(" in rtext and "tunnel_upper <- c(" in rtext


def test_noise5_matrix_dump(capsys):
    # Viterbi_alignment::print_matrices is emitted at noise level 5
    # (viterbi_alignment.cpp:369,2913-3096) for every filled pair;
    # below that level nothing is dumped.
    from pagan2_tpu.utils.log import set_noise
    g1 = build_leaf_graph("ACGT", alph.DNA)
    g2 = build_leaf_graph("AGGT", alph.DNA)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.2)
    try:
        set_noise(5)
        align_pair(g1, g2, model, AlignSettings(), engine="oracle")
        err = capsys.readouterr().err
        # three matrices, ids + scores each; full-prob grids absent
        assert err.count("m\n") >= 2 and "x\n" in err and "y\n" in err
        set_noise(5)
        align_pair(build_leaf_graph("ACGTACGT", alph.DNA),
                   build_leaf_graph("ACGAACGT", alph.DNA), model,
                   AlignSettings(compute_full_score=True), engine="auto")
        err = capsys.readouterr().err
        # device fill: the dump is recomputed on the host oracle and
        # includes the log fwd/bwd/full grids (5 per matrix)
        assert err.count("m\n") >= 5
        set_noise(0)
        align_pair(g1, g2, model, AlignSettings(), engine="oracle")
        assert "x\n" not in capsys.readouterr().err
    finally:
        set_noise(0)


def test_posterior_plot_sink(tmp_path):
    from pagan2_tpu.io import plots
    plots.open_posterior_sink()
    g1 = build_leaf_graph("ACGTACGT", alph.DNA)
    g2 = build_leaf_graph("ACGAACGT", alph.DNA)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.2)
    s = AlignSettings(compute_full_score=True)
    align_pair(g1, g2, model, s)
    out = tmp_path / "post.mp"
    plots.write_mpost_posterior_plots(str(out))
    text = out.read_text()
    assert "beginfig(1)" in text and "fill unitsquare" in text


def test_align_reads_at_root():
    from pagan2_tpu.pipeline.refread import read_reference_alignment
    from pagan2_tpu.pipeline.pileup import pileup_align, PileupConfig
    entries = [FastaEntry(name="a", sequence="ACGTACGTACGTACGTACGT"),
               FastaEntry(name="b", sequence="ACGTACGTACGTACGTACGT")]
    res = read_reference_alignment(entries, "(a:0.1,b:0.1);",
                                   data_type=alph.DNA)
    reads = [FastaEntry(name="q", sequence="ACGTACGTACGTACGT")]
    cfg = PileupConfig(min_query_overlap=0.3, min_query_identity=0.3)
    out = pileup_align(reads, alph.DNA, cfg, root_node=res.tree)
    assert "q" not in out.discarded
    names = {e.name for e in out.alignment}
    assert {"a", "b", "q"} <= names


def test_duplicate_weights_gate():
    from pagan2_tpu.pipeline.pileup import pileup_align, PileupConfig
    reads = [FastaEntry(name="r1", sequence="ACGTACGTACGT",
                        num_duplicates=5),
             FastaEntry(name="r2", sequence="ACGTACGTACGT",
                        num_duplicates=7)]
    cfg = PileupConfig(use_consensus=True, consensus_minimum=1,
                       consensus_minimum_proportion=0.1)
    res_plain = pileup_align(reads, alph.DNA, cfg)
    s = AlignSettings(use_duplicate_weights=True)
    res_dup = pileup_align(reads, alph.DNA, cfg, settings=s)
    g_plain = res_plain.root.graph
    g_dup = res_dup.root.graph
    tot_plain = sum(g_plain.sumA) + sum(g_plain.sumC) + \
        sum(g_plain.sumG) + sum(g_plain.sumT)
    tot_dup = sum(g_dup.sumA) + sum(g_dup.sumC) + \
        sum(g_dup.sumG) + sum(g_dup.sumT)
    assert tot_dup > tot_plain


def test_exhaustive_placement_single_site():
    from pagan2_tpu.pipeline.refread import read_reference_alignment
    from pagan2_tpu.pipeline.placement import (place_queries,
                                               PlacementConfig)
    entries = [FastaEntry(name="a", sequence="ACGTACGTAA"),
               FastaEntry(name="b", sequence="ACGTACGTAA"),
               FastaEntry(name="c", sequence="ACGTACGTAA"),
               FastaEntry(name="d", sequence="ACGTACGTAA")]
    tree = "((a:0.1,b:0.1):0.1,(c:0.1,d:0.1):0.1);"
    res = read_reference_alignment(entries, tree, data_type=alph.DNA)
    queries = [FastaEntry(name="q", sequence="ACGTACGTAA")]
    cfg = PlacementConfig(exhaustive_placement=True,
                          min_query_overlap=0.4, min_query_identity=0.4)
    out = place_queries(res, queries, alph.DNA, cfg)
    assert len(out.placed) == 1


def test_force_gap_band_stays_monotone_and_covered():
    """The --force-gap squeeze must keep A = i + upper and B = i +
    lower non-decreasing — the windowed kernels' searchsorted schedule
    relies on it (band_windows docstring).  Before r5 the squeeze
    dropped `lower` by the block width at the block's entry row,
    de-sorting B: genuinely in-band cells were masked -inf and the
    banded fill silently dead-ended into the full O(L*R) fallback
    --force-gap exists to prevent.  Also checks the banded result
    still matches the unbanded alignment (widen-only repair)."""
    from pagan2_tpu.align import plan_band
    from pagan2_tpu.align.viterbi_banded import band_windows
    rng = np.random.default_rng(9)
    a, _ = _random_pair(rng, 900, 0.0)
    mid1 = "".join(rng.choice(list("ACGT"), size=900))
    mid2 = "".join(rng.choice(list("ACGT"), size=900))
    b, _ = _random_pair(rng, 900, 0.0)
    s1 = a + mid1 + b
    s2 = a + mid2 + b
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    s = AlignSettings(memory_limit_mb=55, force_gap=True,
                      force_gap_threshold=10000, anchor_min_sites=500)
    band, skipped = plan_band(g1, g2, s)
    assert not skipped
    upper, lower = band
    L = g1.num_sites() - 1
    i = np.arange(L, dtype=np.int64)
    A = i + np.asarray(upper[:L], np.int64)
    B = i + np.asarray(lower[:L], np.int64)
    assert np.all(np.diff(A) >= 0), "A de-sorted by the squeeze"
    assert np.all(np.diff(B) >= 0), "B de-sorted by the squeeze"
    # every in-band cell's row must fall inside its diagonal's window
    R = g2.num_sites() - 1
    ilo, W = band_windows(upper, lower, L, R)
    up = np.clip(np.asarray(upper[:L], np.int64), 0, R - 1)
    lo = np.clip(np.asarray(lower[:L], np.int64), 0, R - 1)
    for x in range(0, L, 97):
        for j in (up[x], (up[x] + lo[x]) // 2, lo[x]):
            d = x + j
            assert ilo[d] <= x < ilo[d] + W, (x, j, d, ilo[d], W)


def test_with_reads_anchor_gate_respects_explicit_value():
    """The pipeline anchor-gate override only fires when the caller
    left anchor_min_sites at its default: an explicit user value —
    even one EQUAL to the pipeline gate — must win, and the default
    must be replaced by the pipeline's gate."""
    from dataclasses import replace
    from pagan2_tpu.align.settings import AlignSettings
    s = AlignSettings()
    assert s.with_reads_anchor_gate(200).anchor_min_sites == 200
    custom = replace(s, anchor_min_sites=1234)
    assert custom.with_reads_anchor_gate(200).anchor_min_sites == 1234
    # idempotent under composition with for_reads (the call order the
    # pileup/placement pipelines use)
    assert s.for_reads().with_reads_anchor_gate(
        200).anchor_min_sites == 200


def test_effective_anchor_gate_guards_stats_walk():
    """effective_anchor_gate only lowers the gate for scan-core-bound
    fan-in pairs, and only when the pair size sits between the lowered
    and the global gate (otherwise the decision cannot change)."""
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import alphabets as alph
    from pagan2_tpu.align.viterbi_fanin import (
        effective_anchor_gate, SCAN_ANCHOR_MIN_SITES)
    lin = build_leaf_graph("ACGT" * 150, alph.DNA)     # 600 sites
    # linear chains are never scan-core-bound -> gate unchanged
    assert effective_anchor_gate(lin, lin, 3000) == 3000
    small = build_leaf_graph("ACGT" * 40, alph.DNA)    # 160 < 200
    assert effective_anchor_gate(small, small, 3000) == 3000
    # a deep-offset graph (skip edge spanning > ANCHOR_OFF_CAP sites) IS
    # scan-core-bound: splice a long bwd edge into a 600-site chain
    deep = build_leaf_graph("ACGT" * 150, alph.DNA)
    deep.add_edge(10, 30, 0.5)                         # offset 20 > 7
    assert effective_anchor_gate(deep, lin, 3000) == \
        SCAN_ANCHOR_MIN_SITES
