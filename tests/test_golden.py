"""Golden parity fixtures INDEPENDENT of the oracle (VERDICT r1 item 7).

The reference binary cannot be built here (boost/NCBI/curl absent, no
egress), so these fixtures are hand-derived from first principles: the
expected aligned FASTA rows are written out literally, and the expected
Viterbi scores are closed-form sums assembled directly from the scoring
rules of viterbi_alignment.cpp:2029-2255 / basic_alignment.h:490-542 —
never by running any DP in this repo. A transcription bug in
oracle.py's recurrences (sign, ordering, penalty placement) would break
these, which oracle-vs-kernel parity tests cannot catch.

Score rule cheat-sheet (log space; edge weights are log(1)=0 for plain
leaf chains):
  match from M:   2*lng + ms[a,b]          (score_m_match)
  match from X/Y: close_pen + lng + ms     (score_x/y_match; close_pen
                                            = log(1.0) = 0 internally)
  gap open (M->X/Y):  lng + open_pen       (score_gap_open; open_pen =
                                            lgo internally, 0 when the
                                            predecessor is the start or
                                            a read1 boundary)
  gap extend:     gext (internal) / gend (j or i at 0 / last row-col,
                                          END_GAP, score_gap_ext)
  end corner:     match: lng + ms? no — corner 'match' move adds lng
                  only (m_log = log_non_gap, viterbi_alignment.cpp:
                  1464); gap close into the corner adds close_pen = 0
"""
import subprocess
import sys
import os
import numpy as np
import pytest

from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph
from pagan2_tpu.align import AlignSettings, PairAligner


@pytest.fixture(scope="module")
def model():
    return ModelFactory(alph.DNA).alignment_model(0.2)


def _consts(model):
    return dict(lng=model.log_non_gap(), lgo=model.log_gap_open(),
                gext=model.log_gap_ext(), gend=model.log_gap_end_ext())


def _ms(model, a, b):
    al = alph.get_alphabet(alph.DNA)
    return float(model.log_score[al.state_of(a), al.state_of(b)])


def _engines(g1f, g2f, model, **kw):
    """Yield (name, path, end) for oracle and sheared device engines."""
    from pagan2_tpu.align.viterbi_sheared import sheared_align_path
    s = AlignSettings(**kw)
    a, b = g1f(), g2f()
    yield ("oracle",) + PairAligner(a, b, model, s).align()
    a, b = g1f(), g2f()
    yield ("sheared",) + sheared_align_path(a, b, model, s)


def test_identity_pair_score_and_alignment(model):
    """s1 == s2: all-match path; score = sum(2*lng + ms[c,c]) + lng."""
    seq = "ACGTCA"
    c = _consts(model)
    expected = sum(2 * c["lng"] + _ms(model, ch, ch) for ch in seq) \
        + c["lng"]
    mk = lambda: build_leaf_graph(seq, alph.DNA)  # noqa: E731
    for name, path, end in _engines(mk, mk, model):
        assert end.score == pytest.approx(expected, rel=1e-9), name
        mats = [p.mp.matrix for p in path]
        from pagan2_tpu.align.settings import M_MAT
        assert all(m == M_MAT for m in mats), name


def test_internal_deletion_score(model):
    """s2 is s1 minus its unique 'G': one internal X gap of length 1.
    score = matches-as-2lng except the post-gap match re-enters from X
    with a single lng; gap open from M adds lng + lgo."""
    s1 = "ACTTGTCA"   # G at index 4 (0-based), unique
    s2 = "ACTTTCA"
    c = _consts(model)
    matched = [ch for ch in s1 if ch != "G"]
    expected = (
        sum(2 * c["lng"] + _ms(model, ch, ch) for ch in matched)
        - c["lng"]                       # post-gap match: from X, 1*lng
        + (c["lng"] + c["lgo"])          # X open from M
        + c["lng"]                       # end corner match move
    )
    from pagan2_tpu.align.settings import X_MAT
    mk1 = lambda: build_leaf_graph(s1, alph.DNA)  # noqa: E731
    mk2 = lambda: build_leaf_graph(s2, alph.DNA)  # noqa: E731
    for name, path, end in _engines(mk1, mk2, model):
        assert end.score == pytest.approx(expected, rel=1e-9), name
        gaps = [p for p in path if p.mp.matrix == X_MAT]
        assert len(gaps) == 1, name


def test_trailing_deletion_uses_end_gap_extension(model):
    """s2 misses the last two chars: X gap at j = R-1 is an END_GAP, so
    the second gap column extends with gend, not gext
    (viterbi_alignment.cpp:859-864). The corner resolves via
    gap-close-left (adds 0), NOT a match move (no trailing +lng)."""
    s1 = "ACGTCAGT"
    s2 = "ACGTCA"
    c = _consts(model)
    expected = (
        sum(2 * c["lng"] + _ms(model, ch, ch) for ch in s2)
        + (c["lng"] + c["lgo"])          # X open from M at the end
        + c["gend"]                      # END_GAP extension
    )
    mk1 = lambda: build_leaf_graph(s1, alph.DNA)  # noqa: E731
    mk2 = lambda: build_leaf_graph(s2, alph.DNA)  # noqa: E731
    for name, path, end in _engines(mk1, mk2, model):
        assert end.score == pytest.approx(expected, rel=1e-9), name


def test_leading_insertion_is_free_with_reduced_terminals(model):
    """s2 has two extra leading chars: Y gap at the start. With
    reduced terminal penalties the open at predecessor 0 is free
    (basic_alignment.h:497-500) and extension at j=0? No — the gap
    consumes *right* sites at i=0, so the i gap type applies: i==0 is
    an END_GAP (gend per extra column after the open)."""
    s1 = "GTCAGT"
    s2 = "AAGTCAGT"     # two inserted A's in front (G unique anchor)
    c = _consts(model)
    expected = (
        sum(2 * c["lng"] + _ms(model, ch, ch) for ch in s1)
        - c["lng"]                       # first match re-enters from Y
        + (c["lng"] + 0.0)               # Y open from M: open pen 0
        + c["gend"]                      # second gap col: END_GAP ext
        + c["lng"]                       # end corner match
    )
    mk1 = lambda: build_leaf_graph(s1, alph.DNA)  # noqa: E731
    mk2 = lambda: build_leaf_graph(s2, alph.DNA)  # noqa: E731
    for name, path, end in _engines(mk1, mk2, model):
        assert end.score == pytest.approx(expected, rel=1e-9), name


def _run_cli(tmp_path, fasta_text, tree_text, *extra):
    fas = tmp_path / "in.fas"
    fas.write_text(fasta_text)
    args = [sys.executable, "-m", "pagan2_tpu", "-s", str(fas),
            "-o", str(tmp_path / "out")]
    if tree_text:
        nh = tmp_path / "in.nh"
        nh.write_text(tree_text)
        args += ["-t", str(nh)]
    args += list(extra)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(args, capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return (tmp_path / "out.fas").read_text()


def test_cli_golden_identity(tmp_path, model):
    out = _run_cli(tmp_path, ">a\nACGTCA\n>b\nACGTCA\n",
                   "(a:0.1,b:0.1);\n")
    assert out == ">a\nACGTCA\n>b\nACGTCA\n"


def test_cli_golden_internal_deletion(tmp_path):
    out = _run_cli(tmp_path, ">a\nACTTGTCA\n>b\nACTTTCA\n",
                   "(a:0.1,b:0.1);\n")
    assert out == ">a\nACTTGTCA\n>b\nACTT-TCA\n"


def test_cli_golden_terminal_gaps(tmp_path):
    out = _run_cli(tmp_path, ">a\nACGTCAGT\n>b\nGTCAGT\n",
                   "(a:0.1,b:0.1);\n")
    assert out == ">a\nACGTCAGT\n>b\n--GTCAGT\n"


def test_cli_golden_pileup_substring(tmp_path):
    """Pileup of a unique inner substring read: the read aligns inside
    the first read with terminal gaps on both sides."""
    out = _run_cli(tmp_path, ">r1\nAACCGGTTACGT\n>r2\nCGGTTACG\n",
                   None, "--pileup", "--queryfile",
                   str(tmp_path / "in.fas"))
    # NB: with --pileup the first entry is the starting reference and
    # the rest are stacked onto it
    assert out == ">r1\nAACCGGTTACGT\n>r2\n---CGGTTACG-\n"


def test_codon_identity_alignment(tmp_path):
    """Stop-free codons only: the 61-codon alphabet excludes stops, so
    a TAA would (correctly) come back as NNN (model_factory.h:209-239)."""
    out = _run_cli(tmp_path, ">a\nATGGCATGG\n>b\nATGGCATGG\n",
                   "(a:0.1,b:0.1);\n", "--codons")
    assert out == ">a\nATGGCATGG\n>b\nATGGCATGG\n"


def test_protein_identity_alignment(tmp_path):
    out = _run_cli(tmp_path, ">a\nMKVLAW\n>b\nMKVLAW\n",
                   "(a:0.1,b:0.1);\n")
    assert out == ">a\nMKVLAW\n>b\nMKVLAW\n"


# ----------------------------------------------------------------------
# round-3 corpus growth (VERDICT r2 item 7): 454 skip-edge semantics,
# ancestors with indel edges, non-identity codon/protein cases
# ----------------------------------------------------------------------
def _engines_fanin(g1f, g2f, model, **kw):
    """(name, path, end) for the oracle and BOTH fan-in device cores —
    an edge-iteration-order transcription bug in any of them breaks the
    hand-derived expectations below."""
    from pagan2_tpu.align.viterbi_fanin import fanin_align_path
    from hopper_emulator import kernels_on_cpu
    s = AlignSettings(**kw)
    a, b = g1f(), g2f()
    yield ("oracle",) + PairAligner(a, b, model, s).align()
    a, b = g1f(), g2f()
    yield ("fanin-scan",) + fanin_align_path(a, b, model, s)
    a, b = g1f(), g2f()
    with kernels_on_cpu():
        kernel = fanin_align_path(a, b, model, s)
    yield ("fanin-kernel",) + kernel


def test_454_homopolymer_skip_edge_score(model):
    """FASTQ 454 graph of ACGGGT (run of three Gs -> direct edge w=0.9
    and a skip-one edge w=0.1 into the T, sequence.cpp:456-500) aligned
    to plain ACGGT: the winning path matches A,C,G,G,T and consumes the
    extra G through the 0.1 skip edge — log(0.1) ~ -2.3 beats a gap
    (lng+lgo ~ -6.2) — so
      score = sum(2*lng + ms[c,c] for c in ACGGT)
              + f32(log 0.1)          (left skip-edge weight, match move)
              + lng                   (end-corner match move).
    The skipped G appears as one pushed non-real gap cell."""
    c = _consts(model)
    skip_lw = float(np.float32(np.log(np.float64(0.1))))
    expected = (sum(2 * c["lng"] + _ms(model, ch, ch) for ch in "ACGGT")
                + skip_lw + c["lng"])
    mk454 = lambda: build_leaf_graph(  # noqa: E731
        "ACGGGT", alph.DNA, quality="IIIIII", mode454=True)
    mk = lambda: build_leaf_graph("ACGGT", alph.DNA)  # noqa: E731
    for name, path, end in _engines_fanin(mk454, mk, model):
        # the kernel fills in f32
        tol = 1e-6 if name == "fanin-kernel" else 1e-9
        assert end.score == pytest.approx(expected, rel=tol), name
        real = [p for p in path if p.real_site]
        pushed = [p for p in path if not p.real_site]
        assert len(real) == 5, name
        assert len(pushed) == 1, name
        from pagan2_tpu.align.settings import M_MAT
        assert all(p.mp.matrix == M_MAT for p in real), name


def test_cli_golden_three_leaf_ancestor_indel(tmp_path):
    """3-leaf family whose (a,b) ancestor carries an indel edge
    bridging the deleted GG; aligning c (which also lacks GG, with one
    substitution) must ride that edge — the gen-2 job exercises the
    fan-in engine end-to-end through the CLI. Flanks are long enough
    that the internal gap wins under any empirical base frequencies."""
    out = _run_cli(tmp_path,
                   ">a\nCATTGAGGACGTTC\n>b\nCATTGAACGTTC\n"
                   ">c\nCATTGAACGTTG\n",
                   "((a:0.1,b:0.1):0.05,c:0.1);\n")
    assert out == (">a\nCATTGAGGACGTTC\n>b\nCATTGA--ACGTTC\n"
                   ">c\nCATTGA--ACGTTG\n")


def test_cli_golden_codon_deletion(tmp_path):
    """Non-identity codon case: a whole-codon deletion must come out as
    a frame-aligned triplet gap."""
    out = _run_cli(tmp_path,
                   ">a\nATGAAAGCATGGCCC\n>b\nATGAAATGGCCC\n",
                   "(a:0.1,b:0.1);\n", "--codons")
    assert out == ">a\nATGAAAGCATGGCCC\n>b\nATGAAA---TGGCCC\n"


def test_cli_golden_protein_deletion_and_substitution(tmp_path):
    out = _run_cli(tmp_path, ">a\nMKVLAW\n>b\nMKVAW\n",
                   "(a:0.1,b:0.1);\n")
    assert out == ">a\nMKVLAW\n>b\nMKV-AW\n"
    out = _run_cli(tmp_path, ">a\nMKVLAW\n>b\nMKVIAW\n",
                   "(a:0.1,b:0.1);\n")
    assert out == ">a\nMKVLAW\n>b\nMKVIAW\n"


def test_deep_homopolymer_skip_edge_score(model):
    """Raw fan-in BEYOND the bucket boundary (K=5 -> _k_bucket 6), the
    round-4 regression class: --homopolymer graph of GAAAAAT (run of
    five As -> weight-0.25 skip edges from every earlier A into the T,
    sequence.cpp:253-278; fan-in K=5) aligned to plain GAAAT.  The
    winning path matches G,A,A,A,T and consumes the two extra As
    through ONE skip edge (A3 -> T, log 0.25 ~ -1.39, beating two gap
    cells at ~ lng+lgo+gend ~ -8), so
      score = sum(2*lng + ms[c,c] for c in GAAAT)
              + f32(log 0.25)        (skip-edge weight, match move)
              + lng                  (end-corner match move)
    and the MSA rows are hand-derived:
      a: GAAAAAT
      b: GAA--AT
    A decode with the wrong KR stride (raw 5 vs bucket 6) corrupts the
    backtrack here — this golden fails where oracle-parity tests
    cannot (the oracle never sees the packed codes)."""
    from pagan2_tpu.align.viterbi_fanin import fanin_stats, _k_bucket
    c = _consts(model)
    skip_lw = float(np.float32(np.log(np.float64(0.25))))
    expected = (sum(2 * c["lng"] + _ms(model, ch, ch) for ch in "GAAAT")
                + skip_lw + c["lng"])
    mkhp = lambda: build_leaf_graph(  # noqa: E731
        "GAAAAAT", alph.DNA, homopolymer=True)
    mk = lambda: build_leaf_graph("GAAAT", alph.DNA)  # noqa: E731
    KL, OL = fanin_stats(mkhp())
    assert KL == 5 and _k_bucket(KL) == 6          # raw K != bucket
    for name, path, end in _engines_fanin(mkhp, mk, model):
        tol = 1e-6 if name == "fanin-kernel" else 1e-9
        assert end.score == pytest.approx(expected, rel=tol), name
        real = [p for p in path if p.real_site]
        pushed = [p for p in path if not p.real_site]
        assert len(real) == 5, name
        assert len(pushed) == 2, name
        from pagan2_tpu.align.settings import M_MAT
        assert all(p.mp.matrix == M_MAT for p in real), name


def test_cli_golden_deep_homopolymer(tmp_path):
    """The same K=5 skip-edge case end-to-end through the CLI with
    --homopolymer: the extra As must come out as gap columns in the
    partner row, not corrupt the backtrack."""
    out = _run_cli(tmp_path,
                   ">a\nCGTCGAAAAATGCATGC\n>b\nCGTCGAAATGCATGC\n",
                   "(a:0.05,b:0.05);\n", "--homopolymer")
    assert out == (">a\nCGTCGAAAAATGCATGC\n"
                   ">b\nCGTCGAAA--TGCATGC\n")
    # two-sided: a has a run of SIX As (K=6), b a run of FIVE (raw
    # K=5 -> bucket 6) — the winning backtrack rides a left skip edge
    # (kl >= 1), the geometry a raw-KR decode corrupts
    out = _run_cli(tmp_path,
                   ">a\nCGTCGAAAAAATGCATGC\n>b\nCGTCGAAAAATGCATGC\n",
                   "(a:0.05,b:0.05);\n", "--homopolymer")
    assert out == (">a\nCGTCGAAAAAATGCATGC\n"
                   ">b\nCGTCGAAAAA-TGCATGC\n")


def test_deep_homopolymer_two_sided_fanin_score(model):
    """BOTH sides past-bucket fan-in — the exact round-4 decode
    geometry: M backpointer codes are packed pair = kl*KR_bucket + kr,
    and decoding with raw KR is only wrong when the winning cell has a
    left-candidate index kl >= 1 AND raw KR != _k_bucket(KR).  Left =
    --homopolymer GAAAAAAT (run 6, K=6 = bucket), right = GAAAAAT
    (run 5, K=5 -> bucket 6): the winner matches G,A,A,A,A,A,T on the
    right and consumes the left's extra A through one 0.25 skip edge
    (a kl >= 1 candidate), so
      score = sum(2*lng + ms[c,c] for c in GAAAAAT)
              + f32(log 0.25) + lng
    with one pushed cell.  Unfixed, this decodes divmod(kl*6, 5) and
    produces a corrupt path (verified: mismatching backtrack at
    HEAD~1-of-fix)."""
    from pagan2_tpu.align.viterbi_fanin import fanin_stats, _k_bucket
    c = _consts(model)
    skip_lw = float(np.float32(np.log(np.float64(0.25))))
    expected = (sum(2 * c["lng"] + _ms(model, ch, ch)
                    for ch in "GAAAAAT") + skip_lw + c["lng"])
    mkl = lambda: build_leaf_graph(  # noqa: E731
        "GAAAAAAT", alph.DNA, homopolymer=True)
    mkr = lambda: build_leaf_graph(  # noqa: E731
        "GAAAAAT", alph.DNA, homopolymer=True)
    assert fanin_stats(mkl())[0] == 6
    KR = fanin_stats(mkr())[0]
    assert KR == 5 and _k_bucket(KR) == 6
    for name, path, end in _engines_fanin(mkl, mkr, model):
        tol = 1e-6 if name == "fanin-kernel" else 1e-9
        assert end.score == pytest.approx(expected, rel=tol), name
        real = [p for p in path if p.real_site]
        pushed = [p for p in path if not p.real_site]
        assert len(real) == 7, name
        assert len(pushed) == 1, name
        from pagan2_tpu.align.settings import M_MAT
        assert all(p.mp.matrix == M_MAT for p in real), name
