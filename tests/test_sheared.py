"""Sheared (diagonal-major) fast kernel vs the host oracle: path-exact
equivalence on linear-chain graphs."""
import numpy as np
import pytest

from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph
from pagan2_tpu.align import AlignSettings
from pagan2_tpu.align.oracle import PairAligner
from pagan2_tpu.align.viterbi_sheared import (sheared_align_path,
                                              is_linear_chain)
from tests.test_viterbi_jax import rand_dna, mutate, paths_equal


def compare(s1, s2, data_type=alph.DNA, distance=0.2):
    mf = ModelFactory(data_type)
    model = mf.alignment_model(distance)
    settings = AlignSettings()

    g1o = build_leaf_graph(s1, data_type)
    g2o = build_leaf_graph(s2, data_type)
    path_o, end_o = PairAligner(g1o, g2o, model, settings).align()

    g1s = build_leaf_graph(s1, data_type)
    g2s = build_leaf_graph(s2, data_type)
    assert is_linear_chain(g1s) and is_linear_chain(g2s)
    path_s, end_s = sheared_align_path(g1s, g2s, model, settings)

    assert end_s.score == pytest.approx(end_o.score, rel=1e-12, abs=1e-12)
    assert paths_equal(path_o, path_s), (s1, s2)
    assert g1o.edges.used == g1s.edges.used
    assert g2o.edges.used == g2s.edges.used


class TestShearedMatchesOracle:
    def test_basic(self):
        compare("ACGTACGT", "ACGTACGT")
        compare("ACGTTTACGT", "ACGTACGT")
        compare("ACGT", "TTTT")
        compare("GATTACA", "GACTATA")
        compare("A", "ACGTACGT")

    def test_random(self):
        rng = np.random.default_rng(5)
        for _ in range(12):
            s1 = rand_dna(rng, int(rng.integers(3, 80)))
            s2 = mutate(rng, s1)
            compare(s1, s2)

    def test_protein(self):
        rng = np.random.default_rng(6)
        aas = list(alph.PROTEIN_CHARS)
        for _ in range(3):
            s1 = "".join(rng.choice(aas, size=int(rng.integers(5, 40))))
            s2 = "".join(rng.choice(aas, size=int(rng.integers(5, 40))))
            compare(s1, s2, data_type=alph.PROTEIN, distance=0.5)

    def test_not_linear_rejected(self):
        g = build_leaf_graph("ACCCT", alph.DNA, homopolymer=True)
        assert not is_linear_chain(g)

    def test_progressive_auto_uses_fast_path(self):
        # end-to-end auto engine must produce the same MSA as oracle
        from pagan2_tpu.io.fasta import FastaEntry
        from pagan2_tpu.pipeline import align_progressive
        rng = np.random.default_rng(8)
        base = rand_dna(rng, 50)
        seqs = {n: mutate(rng, base) for n in "abcd"}
        entries = [FastaEntry(name=k, sequence=v) for k, v in seqs.items()]
        tree = "((a:0.1,b:0.12):0.04,(c:0.08,d:0.1):0.06);"
        r1 = align_progressive(entries, tree, engine="oracle")
        r2 = align_progressive(entries, tree, engine="auto")
        for e1, e2 in zip(r1.alignment, r2.alignment):
            assert e1.sequence == e2.sequence, e1.name


@pytest.mark.parametrize("L,R,D", [(5, 7, 11), (40, 30, 69), (30, 40, 50),
                                   (64, 64, 127), (7, 3, 5)])
def test_host_shear_matches_device_shear(L, R, D):
    """The host shear (row copies) equals the jnp gather shear cell for
    cell, including the clipped cells outside each row's diagonals."""
    import jax.numpy as jnp
    from pagan2_tpu.align.viterbi_sheared import _shear, _shear_np
    vals = np.random.default_rng(L * R).random((L, R))
    assert np.array_equal(_shear_np(vals, D),
                          np.asarray(_shear(jnp.asarray(vals), D)))
