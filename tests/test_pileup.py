"""Reference-free pileup mode (milestone C shape).

Oracles: overlapping reads from a known template must stack into an MSA
whose ungapped rows equal the reads; consensus must reconstruct the
template where coverage suffices; non-matching junk reads are discarded.
"""
import numpy as np
import pytest

from pagan2_tpu.io.fasta import FastaEntry
from pagan2_tpu.pipeline.pileup import (pileup_align, PileupConfig,
                                        read_alignment_scores)


TEMPLATE = "ACGGTTACGATCGATTGGCACGTAGCTAGCTTAGGCCATAACGT"


def reads_from_template(rng, n, length=20, step=6, err=0.0):
    reads = []
    for i in range(n):
        start = (i * step) % max(1, len(TEMPLATE) - length)
        s = list(TEMPLATE[start:start + length])
        for k in range(len(s)):
            if rng.random() < err:
                s[k] = "ACGT"[rng.integers(4)]
        reads.append(FastaEntry(name=f"r{i}", sequence="".join(s)))
    return reads


class TestPileup:
    def test_identical_reads(self):
        reads = [FastaEntry(name=f"r{i}", sequence="ACGTTGCA")
                 for i in range(4)]
        res = pileup_align(reads)
        assert len(res.alignment) == 4
        for e in res.alignment:
            assert e.sequence == "ACGTTGCA"
        assert res.discarded == []

    def test_overlapping_reads(self):
        rng = np.random.default_rng(3)
        reads = reads_from_template(rng, 5)
        res = pileup_align(reads)
        by = {e.name: e.sequence for e in res.alignment}
        lengths = {len(s) for s in by.values()}
        assert len(lengths) == 1
        for r in reads:
            if r.name in by:
                assert by[r.name].replace("-", "") == r.sequence

    def test_junk_read_discarded(self):
        reads = [FastaEntry(name="r0", sequence="ACGTTGCAACGTACGT"),
                 FastaEntry(name="r1", sequence="ACGTTGCAACGTACGT"),
                 FastaEntry(name="junk", sequence="TTTTCCCCTTTTCCCC")]
        res = pileup_align(reads)
        assert "junk" in res.discarded
        names = {e.name for e in res.alignment}
        assert "junk" not in names

    def test_reverse_strand(self):
        from pagan2_tpu.graph import revcomp
        reads = [FastaEntry(name="r0", sequence="ACGGTTACGATCGATTGGCA"),
                 FastaEntry(name="r1",
                            sequence=revcomp("ACGGTTACGATCGATTGGCA"))]
        res = pileup_align(reads, config=PileupConfig(both_strands=True))
        assert res.discarded == []
        by = {e.name: e.sequence for e in res.alignment}
        # r1 was flipped back to the forward strand before stacking
        assert by["r1"] == by["r0"]

    def test_consensus(self):
        reads = [FastaEntry(name=f"r{i}", sequence=TEMPLATE)
                 for i in range(6)]
        res = pileup_align(
            reads, config=PileupConfig(use_consensus=True,
                                       consensus_minimum=3))
        assert res.consensus == TEMPLATE

    def test_consensus_majority(self):
        # 5 reads agree, 1 disagrees at one base -> majority wins
        reads = [FastaEntry(name=f"r{i}", sequence=TEMPLATE)
                 for i in range(5)]
        mutated = TEMPLATE[:10] + "G" + TEMPLATE[11:]
        assert TEMPLATE[10] != "G"
        reads.append(FastaEntry(name="odd", sequence=mutated))
        res = pileup_align(
            reads, config=PileupConfig(use_consensus=True,
                                       consensus_minimum=3))
        assert res.consensus == TEMPLATE

    def test_homopolymer_pileup(self):
        # 454-style reads disagreeing on homopolymer run length still stack
        reads = [FastaEntry(name="r0", sequence="ACGGGGTACGTACGT"),
                 FastaEntry(name="r1", sequence="ACGGGTACGTACGT"),
                 FastaEntry(name="r2", sequence="ACGGGGGTACGTACGT")]
        res = pileup_align(reads, config=PileupConfig(homopolymer=True))
        assert res.discarded == []
        lengths = {len(e.sequence) for e in res.alignment}
        assert len(lengths) == 1


def test_both_strands_batches_through_executor():
    """--both-strands must launch the fwd/revcomp pair as ONE batched
    fill per read (VERDICT r2 item 4) with output identical to before."""
    from pagan2_tpu.graph import revcomp
    from pagan2_tpu.parallel import executor
    rng = np.random.default_rng(8)
    tmpl = "".join(rng.choice(list("ACGT"), size=40))
    reads = [FastaEntry(name="r0", sequence=tmpl),
             FastaEntry(name="r1", sequence=revcomp(tmpl)),
             FastaEntry(name="r2", sequence=tmpl[5:35])]
    executor.reset_stats()
    res = pileup_align(reads, config=PileupConfig(both_strands=True))
    assert executor.EXEC_STATS["launches"] >= 1, executor.EXEC_STATS
    assert executor.EXEC_STATS["batched_jobs"] >= 2
    assert res.discarded == []
    by = {e.name: e.sequence for e in res.alignment}
    assert by["r1"] == by["r0"]


def test_build_contigs_includes_read_rows():
    """--build-contigs: each contig's consensus row is followed by the
    aligned read rows (reconstruct_contigs(contigs, false),
    node.h:2066-2073); --output-consensus stays consensus-only."""
    from pagan2_tpu.pipeline.pileup import (pileup_align, PileupConfig,
                                            reconstruct_contigs)
    reads = [FastaEntry("r1", "ACGTACGTGGACTTACGT"),
             FastaEntry("r2", "ACGTACGTGGACTTACGT"),
             FastaEntry("r3", "GGACTTACGTTTGCAGGC")]
    cfg = PileupConfig(min_query_overlap=0.2, min_query_identity=0.2,
                       use_consensus=True, consensus_minimum=1,
                       consensus_minimum_proportion=0.1)
    res = pileup_align(reads, "dna", cfg)
    only = reconstruct_contigs(res.root, cfg, consensus_only=True)
    both = reconstruct_contigs(res.root, cfg, consensus_only=False)
    assert all(e.name.startswith("consensus_") for e in only)
    read_rows = [e for e in both if not
                 e.name.startswith("consensus_")]
    assert read_rows, "contig mode must append the read rows"
    cons = [e for e in both if e.name.startswith("consensus_")]
    # read rows align column-for-column with their consensus
    assert {len(e.sequence) for e in both} == {len(cons[0].sequence)}
    for e in read_rows:
        assert e.sequence.replace("-", "") != ""


def test_placement_contigs_have_real_consensus():
    """--build-contigs on a placement run: spliced graphs accumulate
    pileup counts when PlacementConfig.compute_consensus is set, so the
    contig consensus carries real bases, not all dashes."""
    from pagan2_tpu.pipeline.refread import read_reference_alignment
    from pagan2_tpu.pipeline.placement import (place_queries,
                                               PlacementConfig)
    from pagan2_tpu.pipeline.pileup import (reconstruct_contigs,
                                            PileupConfig)
    entries = [FastaEntry("a", "ACGTACGTGGACTTACGT"),
               FastaEntry("b", "ACGTACGTGGACTTACGT")]
    ref = read_reference_alignment(entries, "(a:0.1,b:0.1);",
                                   data_type="dna")
    qs = [FastaEntry("q1", "ACGTACGTGGACTTACGT"),
          FastaEntry("q2", "ACGTACGTGGACTTACGT")]
    cfg = PlacementConfig(one_placement_only=True,
                          min_query_overlap=0.4, min_query_identity=0.4,
                          compute_consensus=True)
    out = place_queries(ref, qs, "dna", cfg)
    assert len(out.placed) == 2
    ccfg = PileupConfig(consensus_minimum=1,
                        consensus_minimum_proportion=0.1)
    rows = reconstruct_contigs(out.result.tree, ccfg,
                               consensus_only=True)
    assert rows
    body = rows[0].sequence.replace("-", "").replace("n", "")
    assert body, "consensus must carry real bases"


def test_deep_homopolymer_pileup_k5():
    """454-style pileup whose template carries a run of FIVE As: with
    --homopolymer the leaf graphs (and the accumulating root) have raw
    fan-in K=5 — past the _k_bucket boundary (bucket 6) — driven
    through align_pair's single-pair scan path.  The round-4 kr_decode
    regression corrupted exactly this decode (the canonical
    reference-README 454 demo, README.md:24-45); reads must stack,
    nothing discarded, and the consensus must recover the template."""
    tmpl = "CGTCGTACGAAAAATGCATGCTGACTGAC"
    # the overcall read merges FIRST so the accumulating root carries
    # the extra-A bridge (left-candidate index >= 1) before the run-5
    # reads (right raw K=5, bucket 6) align — the two-sided geometry
    # the raw-KR decode corrupts
    reads = [FastaEntry(name="r0", sequence=tmpl),
             FastaEntry(name="r3",
                        sequence=tmpl.replace("AAAAA", "AAAAAA")),
             FastaEntry(name="r1", sequence=tmpl[:22]),
             FastaEntry(name="r2", sequence=tmpl[6:]),
             FastaEntry(name="r4",
                        sequence=tmpl.replace("AAAAA", "AAAA"))]
    from pagan2_tpu.align.viterbi_fanin import fanin_stats, _k_bucket
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import alphabets as alph_
    g = build_leaf_graph(tmpl, alph_.DNA, homopolymer=True)
    assert fanin_stats(g)[0] >= 5 and _k_bucket(5) != 5
    res = pileup_align(reads, config=PileupConfig(homopolymer=True,
                                                  use_consensus=True))
    assert res.discarded == []
    lengths = {len(e.sequence) for e in res.alignment}
    assert len(lengths) == 1
    # consensus is coverage-thresholded at the tails and homopolymer
    # skip edges let majority paths shorten the run; the well-covered
    # core must survive with the run length within one of the template
    core = res.consensus.replace("-", "")
    assert "ACGAAAA" in core and "TGCATGCT" in core, res.consensus


def test_banded_reads_match_unbanded():
    """Read-vs-root alignments anchor from anchor_reads_min_sites=200
    (the reference anchors every pair, node.cpp:87-152) — the banded
    pileup must produce IDENTICAL rows to the
    unbanded one."""
    rng = np.random.default_rng(31)
    parts, total = [], 0
    while total < 230:
        c = "ACGT"[int(rng.integers(0, 4))]
        parts.append(c * int(rng.integers(1, 5)))
        total += len(parts[-1])
    genome = "".join(parts)
    reads = []
    for k in range(8):
        start = int(rng.integers(0, len(genome) - 210))
        r = []
        for c in genome[start:start + 210]:
            u = rng.random()
            if u < 0.01:
                r.append(c + c)
            elif u < 0.02:
                pass
            else:
                r.append(c)
        reads.append(FastaEntry(f"r{k}", "".join(r)))

    def rows(min_sites):
        res = pileup_align(
            reads, config=PileupConfig(homopolymer=True,
                                       use_consensus=True,
                                       anchor_reads_min_sites=min_sites))
        return ({e.name: e.sequence for e in res.alignment},
                res.consensus, res.discarded)

    banded = rows(200)
    unbanded = rows(10 ** 9)
    assert banded == unbanded
