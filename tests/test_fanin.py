"""Fan-in ring-buffer kernel (viterbi_fanin): exact parity vs the host
oracle on graphs with real fan-in (454 / homopolymer error edges,
ancestors with indels), banded fills, and the batched executor path.

The reference's hot kernel iterates edge pairs per cell
(viterbi_alignment.cpp:1353-1436) and tunnels every pair, graph or not
(:44-185); these fills are the device equivalent."""
import numpy as np
import pytest

from pagan2_tpu.align import AlignSettings, align_pair
from pagan2_tpu.align.oracle import PairAligner
from pagan2_tpu.align.viterbi_fanin import (fanin_align_path, fanin_stats,
                                            prepare_fanin,
                                            fanin_device_eligible)
from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph


def _sig(path):
    return [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind, p.mp.x_edge_ind,
             p.mp.y_edge_ind) for p in path]


def _graphs(trial, rng, n=40):
    s1 = "".join(rng.choice(list("AACCGGTT"), size=n))
    s2 = "".join(rng.choice(list("AACCGGTT"), size=n - 5))
    g1 = build_leaf_graph(s1, alph.DNA, homopolymer=True)
    g2 = build_leaf_graph(s2, alph.DNA, mode454=(trial % 2 == 0))
    return g1, g2, s1, s2


def test_fanin_matches_oracle_on_error_edge_graphs():
    rng = np.random.default_rng(1)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    settings = AlignSettings()
    checked = 0
    for trial in range(5):
        g1, g2, s1, s2 = _graphs(trial, rng, n=30 + 6 * trial)
        if not (fanin_device_eligible(
                prepare_fanin(g1, g2, model, settings))):
            continue
        assert max(fanin_stats(g1)[0], fanin_stats(g2)[0]) > 1
        opath, oend = PairAligner(g1, g2, model, settings).align()
        g1b = build_leaf_graph(s1, alph.DNA, homopolymer=True)
        g2b = build_leaf_graph(s2, alph.DNA, mode454=(trial % 2 == 0))
        fpath, fend = fanin_align_path(g1b, g2b, model, settings)
        assert _sig(fpath) == _sig(opath)
        assert abs(fend.score - oend.score) < 1e-9
        checked += 1
    assert checked >= 3


def test_fanin_matches_oracle_on_ancestor_graphs():
    """Deep progressive case: ancestors with indels have skipped edges
    (fan-in); aligning two such ancestors must match the oracle."""
    rng = np.random.default_rng(7)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.2)
    settings = AlignSettings()

    base = rng.choice(list("ACGT"), size=60)

    def leaf(drop):
        mut = base.copy()
        idx = rng.random(60) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        s = "".join(mut)
        if drop:
            s = s[:20] + s[26:]   # interior indel -> bridging edges
        return build_leaf_graph(s, alph.DNA)

    anc1, _ = align_pair(leaf(False), leaf(True), model, settings,
                         engine="oracle")
    anc2, _ = align_pair(leaf(True), leaf(False), model, settings,
                         engine="oracle")
    KL, OL = fanin_stats(anc1)
    KR, OR = fanin_stats(anc2)
    assert max(KL, KR) > 1  # the indel really produced fan-in

    import copy
    a1, a2 = copy.deepcopy(anc1), copy.deepcopy(anc2)
    opath, oend = PairAligner(anc1, anc2, model, settings).align()
    fpath, fend = fanin_align_path(a1, a2, model, settings)
    assert _sig(fpath) == _sig(opath)
    assert abs(fend.score - oend.score) < 1e-9


def test_fanin_banded_matches_unbanded():
    rng = np.random.default_rng(3)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.2)
    settings = AlignSettings()
    base = rng.choice(list("ACGT"), size=300)
    mut = base.copy()
    idx = rng.random(300) < 0.08
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    g1 = build_leaf_graph("".join(base), alph.DNA, homopolymer=True)
    g2 = build_leaf_graph("".join(mut), alph.DNA, homopolymer=True)
    L = g1.num_sites() - 1
    R = g2.num_sites() - 1
    # diagonal band of width 24
    upper = np.maximum(np.arange(L) * R // L - 12, 0)
    lower = np.minimum(np.arange(L) * R // L + 12, R - 1)

    import copy
    g1b, g2b = copy.deepcopy(g1), copy.deepcopy(g2)
    fpath, fend = fanin_align_path(g1, g2, model, settings)
    bpath, bend = fanin_align_path(g1b, g2b, model, settings,
                                   band=(upper, lower))
    assert _sig(bpath) == _sig(fpath)
    assert abs(bend.score - fend.score) < 1e-9


def test_executor_batches_fanin_generations():
    """Ancestor generations with fan-in go through the batched fan-in
    launch (not one-by-one singles)."""
    from pagan2_tpu.io.fasta import FastaEntry
    from pagan2_tpu.parallel import executor
    from pagan2_tpu.pipeline.progressive import align_progressive

    rng = np.random.default_rng(5)
    base = rng.choice(list("ACGT"), size=100)
    entries = []
    for i in range(8):
        mut = base.copy()
        idx = rng.random(100) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        s = "".join(mut)
        if i % 2:
            s = s[:30] + s[36:]   # indel -> ancestors get skipped edges
        entries.append(FastaEntry(name=f"s{i}", sequence=s))
    newick = ("(((s0:0.1,s1:0.1):0.05,(s2:0.1,s3:0.1):0.05):0.02,"
              "((s4:0.1,s5:0.1):0.05,(s6:0.1,s7:0.1):0.05):0.02);")

    executor.reset_stats()
    res = align_progressive(entries, newick, data_type=alph.DNA)
    # 7 jobs total; gen2 (2 jobs) + gen3 (1 job) involve fan-in
    # ancestors; gen2 must have batched through the fan-in launcher
    assert executor.EXEC_STATS["batched_jobs"] >= 6, executor.EXEC_STATS

    res_o = align_progressive(entries, newick, data_type=alph.DNA,
                              engine="oracle")
    assert {e.name: e.sequence for e in res.alignment} == \
        {e.name: e.sequence for e in res_o.alignment}


# ----------------------------------------------------------------------
# Hopper fan-in kernel (hopper.fanin_fill, kernel loop emulated on the
# CPU): the fanin_align_path / executor dispatch must route through it
# with identical results

from hopper_emulator import kernels_on_cpu  # noqa: E402
from pagan2_tpu.align.viterbi_fanin import fanin_overcap  # noqa: E402


def _kernel_eligible(inp):
    return not fanin_overcap(inp["KL"], inp["KR"], inp["OL"], inp["OR"])


def test_pallas_fanin_dispatch_matches_scan_and_oracle():
    rng = np.random.default_rng(11)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    settings = AlignSettings()
    checked = 0
    for trial in range(4):
        g1, g2, s1, s2 = _graphs(trial, rng, n=34 + 7 * trial)
        inp = prepare_fanin(g1, g2, model, settings)
        if not fanin_device_eligible(inp) or not _kernel_eligible(inp):
            continue
        opath, oend = PairAligner(g1, g2, model, settings).align()

        def rebuild():
            a = build_leaf_graph(s1, alph.DNA, homopolymer=True)
            b = build_leaf_graph(s2, alph.DNA, mode454=(trial % 2 == 0))
            return a, b

        ga, gb = rebuild()
        spath, send = fanin_align_path(ga, gb, model, settings)  # scan
        ga, gb = rebuild()
        with kernels_on_cpu():
            ppath, pend = fanin_align_path(ga, gb, model, settings)
        assert _sig(ppath) == _sig(opath) == _sig(spath)
        assert pend.score == pytest.approx(oend.score, rel=1e-5)
        checked += 1
    assert checked >= 2


def test_pallas_fanin_banded_masks_match_windowed_scan():
    """The fan-in kernel fills a band in its window, with the band
    bounds as masks inside it; the path must equal the windowed scan's
    banded fill."""
    rng = np.random.default_rng(12)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.25)
    settings = AlignSettings()
    n = 50
    s1 = "".join(rng.choice(list("AACCGGTT"), size=n))
    s2 = s1[:12] + s1[18:]      # related, with an indel

    def rebuild():
        a = build_leaf_graph(s1, alph.DNA, mode454=True)
        b = build_leaf_graph(s2, alph.DNA, mode454=True)
        return a, b

    ga, gb = rebuild()
    L = ga.num_sites() - 1
    R = gb.num_sites() - 1
    upper = np.maximum(np.arange(L) - 12, 0).astype(np.int32)
    lower = np.minimum(np.arange(L) + 12, R - 1).astype(np.int32)
    spath, send = fanin_align_path(ga, gb, model, settings,
                                   band=(upper, lower))
    ga, gb = rebuild()
    with kernels_on_cpu():
        ppath, pend = fanin_align_path(ga, gb, model, settings,
                                       band=(upper, lower))
    assert _sig(ppath) == _sig(spath)
    assert pend.score == pytest.approx(send.score, rel=1e-5)


def test_fanin_kernel_fills_only_the_band_window(monkeypatch):
    """An anchored fan-in pair gives the kernel its band window: a
    D x W backpointer plane with W well below Lp (the memory the
    windowed scan core needs), not the dense D x Lp plane."""
    import hopper_emulator
    from pagan2_tpu.align import hopper
    from pagan2_tpu.align.viterbi_banded import band_windows
    from pagan2_tpu.align.viterbi_sheared import _bucket
    rng = np.random.default_rng(14)
    model = ModelFactory(alph.DNA).alignment_model(0.25)
    settings = AlignSettings()
    base = rng.choice(list("ACGT"), size=400)
    base[100:105] = "A"
    base[300:304] = "C"
    s1 = "".join(base)
    s2 = s1[:150] + s1[156:]

    def rebuild():
        return (build_leaf_graph(s1, alph.DNA, mode454=True),
                build_leaf_graph(s2, alph.DNA, mode454=True))

    ga, gb = rebuild()
    L, R = ga.num_sites() - 1, gb.num_sites() - 1
    upper = np.maximum(np.arange(L) - 16, 0).astype(np.int32)
    lower = np.minimum(np.arange(L) + 16, R - 1).astype(np.int32)
    spath, send = fanin_align_path(ga, gb, model, settings,
                                   band=(upper, lower))
    shapes = []

    def spy(*args):
        bp, snap = hopper_emulator.emulate_fanin(*args)
        shapes.append((bp.shape, np.asarray(args[7])))
        return bp, snap

    ga, gb = rebuild()
    with kernels_on_cpu():
        monkeypatch.setattr(hopper, "_call_fanin", spy)
        ppath, pend = fanin_align_path(ga, gb, model, settings,
                                       band=(upper, lower))
    assert _sig(ppath) == _sig(spath)
    assert pend.score == pytest.approx(send.score, rel=1e-5)
    (bshape, ilo), = shapes
    Lp = _bucket(L)
    ilo_r, Wreal = band_windows(upper, lower, L, R)
    assert bshape == (1, Lp + _bucket(R) - 1, _bucket(Wreal))
    assert bshape[2] < Lp // 4
    assert np.array_equal(ilo[0, :len(ilo_r)], ilo_r)


def test_pallas_fanin_batch_executor_matches_single():
    """The batched executor's fan-in kernel launch must produce the
    same ancestors as per-job scan fills."""
    import copy
    from pagan2_tpu.parallel.executor import execute_pair_jobs, PairJob
    rng = np.random.default_rng(13)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    settings = AlignSettings()
    jobs = []
    singles = []
    for t in range(3):
        g1, g2, s1, s2 = _graphs(t, rng, n=30 + 5 * t)
        inp = prepare_fanin(g1, g2, model, settings)
        if not fanin_device_eligible(inp):
            continue
        jobs.append(PairJob(left=copy.deepcopy(g1),
                            right=copy.deepcopy(g2), model=model,
                            settings=settings))
        singles.append(fanin_align_path(g1, g2, model, settings))
    assert len(jobs) >= 2
    with kernels_on_cpu():
        results = execute_pair_jobs(jobs)
    for (anc, end), (spath, send) in zip(results, singles):
        assert end.score == pytest.approx(send.score, rel=1e-5)


def test_beyond_cap_graphs_take_banded_fanin_path():
    """Graphs beyond the one-hot caps (deep homopolymer runs: K > 8,
    offsets > 8) must run the windowed gather core with oracle-identical
    paths — banded and unbanded — instead of the dense-plane fallback
    (VERDICT r2 item 5; the reference tunnels every pair,
    tunnel_matrix.h:45-152)."""
    rng = np.random.default_rng(91)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    settings = AlignSettings()
    base = rng.choice(list("ACGT"), size=60)
    base[20:34] = "A"                     # 14-run -> fan-in 15
    s1 = "".join(base)
    mut = base.copy()
    idx = rng.random(60) < 0.12
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    s2 = "".join(mut)

    def rebuild():
        return (build_leaf_graph(s1, alph.DNA, homopolymer=True),
                build_leaf_graph(s2, alph.DNA, homopolymer=True))

    g1, g2 = rebuild()
    KL, OL = fanin_stats(g1)
    assert KL > 8 and OL > 8            # genuinely beyond-cap
    assert not fanin_device_eligible(prepare_fanin(g1, g2, model,
                                                   settings))
    opath, oend = PairAligner(g1, g2, model, settings).align()

    g1, g2 = rebuild()
    dpath, dend = fanin_align_path(g1, g2, model, settings)
    assert _sig(dpath) == _sig(opath)
    assert dend.score == pytest.approx(oend.score, rel=1e-9)

    # generous band: same result, windowed storage
    g1, g2 = rebuild()
    L = g1.num_sites() - 1
    R = g2.num_sites() - 1
    upper = np.maximum(np.arange(L) - 20, 0).astype(np.int32)
    lower = np.minimum(np.arange(L) + 20, R - 1).astype(np.int32)
    bpath, bend = fanin_align_path(g1, g2, model, settings,
                                   band=(upper, lower))
    assert _sig(bpath) == _sig(opath)

    # align_pair dispatch must land on the fan-in path too
    g1, g2 = rebuild()
    from pagan2_tpu.align import align_pair
    anc, aend = align_pair(g1, g2, model, settings, use_anchors=False)
    assert aend.score == pytest.approx(oend.score, rel=1e-9)


def test_batched_beyond_cap_gather_core():
    """A batched (B>1) fan-in launch whose offsets force the gather
    core (OL*OR > 64 at K <= K_CAP: ancestors with long indel bridges)
    must match per-job fills — the broadcast in the stacked-candidate
    gather once collided the batch axis with a slot axis for B > 1."""
    import copy
    from pagan2_tpu.align import align_pair
    from pagan2_tpu.parallel.executor import (execute_pair_jobs, PairJob,
                                              EXEC_STATS, reset_stats)
    rng = np.random.default_rng(17)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    settings = AlignSettings()
    jobs = []
    singles = []
    for t in range(2):
        base = rng.choice(list("ACGT"), size=60)
        s1 = "".join(base)
        s2 = s1[:20] + s1[32:]        # 12-char deletion -> bridge o=13
        ga = build_leaf_graph(s1, alph.DNA)
        gb = build_leaf_graph(s2, alph.DNA)
        anc, _ = align_pair(ga, gb, model, settings)
        # right side is an ancestor too, so BOTH sides carry a long
        # bridge edge and OL*OR crosses the one-hot cap
        s3 = "".join(np.where(rng.random(60) < 0.08,
                              rng.choice(list("ACGT"), size=60), base))
        s4 = s3[:25] + s3[37:]
        gc_ = build_leaf_graph(s3, alph.DNA)
        gd = build_leaf_graph(s4, alph.DNA)
        leaf, _ = align_pair(gc_, gd, model, settings)
        KL, OL = fanin_stats(anc)
        KR, OR = fanin_stats(leaf)
        # in the batched-bucket regime: K within cap, OL*OR beyond the
        # one-hot core cap -> gather core
        assert KL <= 8 and OL + OR <= 64 and OL * OR > 64, (KL, OL, OR)
        jobs.append(PairJob(left=copy.deepcopy(anc),
                            right=copy.deepcopy(leaf), model=model,
                            settings=settings))
        singles.append(fanin_align_path(copy.deepcopy(anc),
                                        copy.deepcopy(leaf), model,
                                        settings))
    reset_stats()
    results = execute_pair_jobs(jobs)
    assert EXEC_STATS["batched_jobs"] == 2, EXEC_STATS
    for (anc2, end), (spath, send) in zip(results, singles):
        assert end.score == pytest.approx(send.score, rel=1e-9)


# ----------------------------------------------------------------------
# K-creep bucketing parity: kernel keys are bucketed (_k_bucket /
# _g_bucket) so a pileup root whose raw fan-in creeps up one edge at a
# time reuses compiled kernels.  The fill then packs M backpointer
# codes with stride = BUCKETED KR, so every decode must use the same
# bucket (round-4 regression: the single-pair scan path decoded with
# raw KR and corrupted backtracks whenever raw K was not a bucket
# value — first at K=5).  These sweeps drive raw KL/KR 1..9 (and
# OL+OR across _g_bucket boundaries, since O=K for homopolymer runs)
# through ALL THREE fill paths and demand oracle-identical alignments.

def _k_pair(k, seed=0):
    """A graph pair whose left raw fan-in is exactly k (homopolymer
    run of length k) aligned against a related partner."""
    rng = np.random.default_rng(100 + 10 * k + seed)

    def flank(n):
        # run-free and never adjacent to the A-run, so the run of
        # length k is the graph's only fan-in source
        out, prev = [], "A"
        for _ in range(n):
            c = str(rng.choice([x for x in "CGT" if x != prev]))
            out.append(c)
            prev = c
        return "".join(out)

    pre, post = flank(8), flank(10)
    s1 = pre + "A" * k + post
    s2 = pre[:-1] + "A" * max(k - 1, 1) + post[1:]
    g1 = build_leaf_graph(s1, alph.DNA, homopolymer=True)
    g2 = build_leaf_graph(s2, alph.DNA, homopolymer=True)
    return g1, g2, s1, s2


def test_k_creep_scan_core_sweep():
    """Single-pair SCAN core (the CPU default and the over-cap
    fallback) across raw K = 1..9: bucketed fill + decode must match
    the oracle exactly.  Reverting the kr_decode fix fails this at
    K = 5 (bucket 6)."""
    from pagan2_tpu.align.viterbi_fanin import _k_bucket
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    settings = AlignSettings()
    hit_nontrivial_bucket = 0
    for k in range(1, 10):
        g1, g2, s1, s2 = _k_pair(k)
        KL, OL = fanin_stats(g1)
        assert KL == k and OL == k
        if _k_bucket(k) != k:
            hit_nontrivial_bucket += 1
        opath, oend = PairAligner(g1, g2, model, settings).align()
        ga = build_leaf_graph(s1, alph.DNA, homopolymer=True)
        gb = build_leaf_graph(s2, alph.DNA, homopolymer=True)
        fpath, fend = fanin_align_path(ga, gb, model, settings)
        assert _sig(fpath) == _sig(opath), f"raw K={k}"
        assert fend.score == pytest.approx(oend.score, rel=1e-9)
    assert hit_nontrivial_bucket >= 3   # 5, 7, 9 exercise bucket != raw


def test_k_creep_pallas_interpret_sweep():
    """Single-pair KERNEL path (emulated) across raw K = 1..8:
    same bucketed decode contract as the scan core."""
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    settings = AlignSettings()
    checked = []
    for k in (2, 4, 5, 7, 8):     # 5, 7 are the non-bucket values
        g1, g2, s1, s2 = _k_pair(k, seed=1)
        inp = prepare_fanin(g1, g2, model, settings)
        if not _kernel_eligible(inp):
            continue
        opath, oend = PairAligner(g1, g2, model, settings).align()
        ga = build_leaf_graph(s1, alph.DNA, homopolymer=True)
        gb = build_leaf_graph(s2, alph.DNA, homopolymer=True)
        with kernels_on_cpu():
            ppath, pend = fanin_align_path(ga, gb, model, settings)
        assert _sig(ppath) == _sig(opath), f"raw K={k}"
        assert pend.score == pytest.approx(oend.score, rel=1e-5)
        checked.append(k)
    # the non-bucket K=5 (bucket 6) must be exercised
    assert 5 in checked and len(checked) >= 3, checked


@pytest.mark.parametrize("n_shards", [1, 4])
def test_k_creep_executor_batch(n_shards):
    """Executor batch path (n_shards 1 and >1) with mixed raw K
    including non-bucket values (5, 7): batched bucketed fills must
    match per-job scan fills."""
    import copy
    import jax
    from pagan2_tpu.parallel import executor
    from pagan2_tpu.parallel.executor import execute_pair_jobs, PairJob
    if n_shards > 1 and jax.device_count() < n_shards:
        pytest.skip("needs the multi-device CPU mesh")
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    settings = AlignSettings()
    jobs, singles = [], []
    for k in (2, 5, 7, 5):
        g1, g2, s1, s2 = _k_pair(k, seed=2)
        jobs.append(PairJob(left=copy.deepcopy(g1),
                            right=copy.deepcopy(g2), model=model,
                            settings=settings))
        singles.append(PairAligner(g1, g2, model, settings).align())
    mesh = executor.make_jobs_mesh(n_shards) if n_shards > 1 else None
    results = execute_pair_jobs(jobs, mesh=mesh)
    for (anc, end), (opath, oend) in zip(results, singles):
        assert end.score == pytest.approx(oend.score, rel=1e-6)
