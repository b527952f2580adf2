"""Device full-probability parity: the sheared scaled fwd/bwd scans
(align/fullprob.py) must reproduce the host oracle's fwd_score /
bwd_score / full_score cell-by-cell, the annotated Viterbi path, and the
stochastic sampler's draws (viterbi_alignment.cpp:329-371, 975-1034,
1193-1322)."""
import numpy as np
import pytest
from dataclasses import replace

from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph
from pagan2_tpu.align import AlignSettings, PairAligner, PathPtr
from pagan2_tpu.align.fullprob import (FullProbPlanes,
                                       fullprob_viterbi_path,
                                       sample_path_planes)
from pagan2_tpu.align.settings import X_MAT, Y_MAT, M_MAT


def _pair(seed=0, n1=30, n2=None, sub=0.15):
    rng = np.random.default_rng(seed)
    n2 = n2 or n1
    base = rng.choice(list("ACGT"), size=max(n1, n2))
    s1 = "".join(base[:n1])
    mut = base[:n2].copy()
    idx = rng.random(n2) < sub
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph("".join(mut), alph.DNA)
    return g1, g2


@pytest.fixture
def model():
    return ModelFactory(alph.DNA).alignment_model(0.3)


def _filled_oracle(g1, g2, model):
    s = replace(AlignSettings(), compute_full_score=True)
    a = PairAligner(g1, g2, model, s)
    end = a.fill()
    return a, end, s


@pytest.mark.parametrize("seed,n1,n2", [(0, 24, 24), (1, 17, 31),
                                        (2, 40, 22)])
def test_planes_match_oracle_cells(model, seed, n1, n2):
    g1, g2 = _pair(seed, n1, n2)
    a, end, s = _filled_oracle(g1, g2, model)
    planes = FullProbPlanes(g1, g2, model, s)

    assert planes.total_fwd_score() == pytest.approx(end.fwd_score,
                                                     rel=1e-9)
    assert np.exp(planes.log_total_bwd) == pytest.approx(
        a.bwd_full_probability, rel=1e-9)

    mats = {M_MAT: a.M, X_MAT: a.X, Y_MAT: a.Y}
    for i in range(planes.L):
        for j in range(planes.R):
            for mk, om in mats.items():
                c = om[i][j]
                assert planes.fwd(mk, i, j) == pytest.approx(
                    c.fwd_score, rel=1e-9, abs=1e-300), (mk, i, j)
                assert planes.bwd(mk, i, j) == pytest.approx(
                    c.bwd_score, rel=1e-9, abs=1e-300), (mk, i, j)
                assert planes.posterior(mk, i, j) == pytest.approx(
                    c.full_score, rel=1e-8, abs=1e-12), (mk, i, j)


def test_long_pair_no_overflow(model):
    """The match scores are log-odds-scaled (>1 for matches), so raw
    products OVERFLOW f64 after ~700 matched sites (the oracle's
    fwd_score goes inf); the scaled planes must stay finite and
    self-consistent (fwd/bwd 1% check)."""
    g1, g2 = _pair(11, 900, 900, sub=0.05)
    s = replace(AlignSettings(), compute_full_score=True)
    planes = FullProbPlanes(g1, g2, model, s)
    assert np.isfinite(planes.log_total)
    assert planes.log_total > 710  # exp() overflows f64: oracle dies here
    ratio = np.exp(planes.log_total - planes.log_total_bwd)
    assert 0.99 < ratio < 1.01
    # posteriors stay meaningful: high on the diagonal, ~0 far off it
    p = planes.posterior(M_MAT, 450, 450)
    assert 0.0 <= p <= 1.0 + 1e-9
    assert p > 0.5
    assert planes.posterior(M_MAT, 450, 45) < 1e-6


def test_viterbi_annotation_matches_oracle(model):
    g1, g2 = _pair(3, 28, 24, sub=0.3)
    a, end, s = _filled_oracle(g1, g2, model)
    opath = a._backtrack(PathPtr(end, True))

    path, dend, planes = fullprob_viterbi_path(g1, g2, model, s)
    assert len(path) == len(opath)
    for dp, op in zip(path, opath):
        assert (dp.mp.matrix, dp.mp.x_ind, dp.mp.y_ind) == \
            (op.mp.matrix, op.mp.x_ind, op.mp.y_ind)
        assert dp.mp.full_score == pytest.approx(op.mp.full_score,
                                                 rel=1e-8, abs=1e-12)
    assert dend.fwd_score == pytest.approx(end.fwd_score, rel=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_sampler_matches_oracle_draws(model, seed):
    """Same RNG stream -> same sampled path as the oracle sampler (the
    candidate sets are identical up to a common per-diagonal scale, so
    every cumulative draw lands on the same candidate)."""
    g1, g2 = _pair(7, 20, 20, sub=0.2)
    s = replace(AlignSettings(), compute_full_score=True,
                sample_path=True)
    a = PairAligner(g1, g2, model, s)
    a.fill()
    opath, _ = a.sample_path(np.random.default_rng(seed))

    g1b, g2b = _pair(7, 20, 20, sub=0.2)
    planes = FullProbPlanes(g1b, g2b, model, s)
    dpath, _ = sample_path_planes(planes, s,
                                  np.random.default_rng(seed))
    okeys = [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in opath]
    dkeys = [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in dpath]
    assert okeys == dkeys
    for dp, op in zip(dpath, opath):
        assert dp.mp.full_score == pytest.approx(op.mp.full_score,
                                                 rel=1e-8, abs=1e-12)


def test_posterior_plane_matches_oracle(model):
    g1, g2 = _pair(5, 15, 18, sub=0.1)
    a, end, s = _filled_oracle(g1, g2, model)
    planes = FullProbPlanes(g1, g2, model, s)
    ref = np.zeros((planes.L - 1, planes.R - 1))
    for i in range(planes.L - 1):
        for j in range(planes.R - 1):
            ref[i, j] = max(a.M[i][j].full_score, a.X[i][j].full_score,
                            a.Y[i][j].full_score)
    got = planes.posterior_plane()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-12)


def test_align_pair_fullprob_uses_device(model, monkeypatch):
    """align_pair with compute_full_score on chain graphs must route
    through FullProbPlanes, not the oracle fill."""
    import pagan2_tpu.align as al

    called = {}
    orig = al.PairAligner.fill

    def spy(self):
        called["oracle"] = True
        return orig(self)

    monkeypatch.setattr(al.PairAligner, "fill", spy)
    g1, g2 = _pair(8, 20, 20)
    s = replace(AlignSettings(), compute_full_score=True)
    anc, _ = al.align_pair(g1, g2, model, s)
    assert "oracle" not in called
    assert anc.check_valid_graph()
    sup = anc.posterior_support[1:-1]
    assert any(0 < v < 1 for v in sup)
