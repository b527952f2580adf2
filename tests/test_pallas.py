"""Linear-chain and windowed band fills through the Hopper kernels'
wrappers (argument packing, padding, window schedule, backpointer
decode), with the kernel loops run as NumPy transcriptions
(tests/hopper_emulator.py): backpointer planes and corner scores must
equal the scan cores', and paths the host oracle's."""
import numpy as np
import pytest

from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph
from pagan2_tpu.align import AlignSettings, hopper
from pagan2_tpu.align.oracle import PairAligner
from pagan2_tpu.align.viterbi_sheared import (
    sheared_align_path, prepare_sheared, shear_device_inputs,
    sheared_fill, _bucket, _ShearedCells)
from pagan2_tpu.align.viterbi_banded import (
    banded_align_path, banded_fill_args, band_schedule)

pytestmark = pytest.mark.usefixtures("emulated_kernels")


def _random_pair(rng, n1, n2, sub=0.1):
    base = rng.choice(list("ACGT"), size=max(n1, n2))
    s1 = "".join(base[:n1])
    mut = base[:n2].copy()
    idx = rng.random(n2) < sub
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return s1, "".join(mut)


def _path_states(path):
    return [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in path]


def _scan_plane(g1, g2, model, settings, band=None):
    """The sheared scan core's (bp, corner) for one pair, in f32."""
    inp = prepare_sheared(g1, g2, model, settings, np.float32)
    args = shear_device_inputs(inp, Lp=_bucket(inp["L"]),
                               Rp=_bucket(inp["R"]),
                               upper=band[0] if band else None,
                               lower=band[1] if band else None)
    bp, final = sheared_fill(*args)
    return np.asarray(bp).view(np.uint8), np.asarray(final)


def _kernel_plane(g1, g2, model, settings, band=None):
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    Lp, Rp = _bucket(L), _bucket(R)
    job = hopper.linear_job(g1, g2, model, settings, Lp, Rp, band=band)
    bp, fin = hopper.linear_fill([job], Lp + Rp - 1, Lp)
    return bp[0], fin[0]


@pytest.mark.parametrize("seed,n1,n2", [(0, 40, 40), (1, 37, 52),
                                        (2, 64, 30), (3, 9, 9)])
def test_pallas_matches_sheared_and_oracle(seed, n1, n2):
    rng = np.random.default_rng(seed)
    s1, s2 = _random_pair(rng, n1, n2)
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    model = ModelFactory(alph.DNA).alignment_model(0.3)
    settings = AlignSettings()

    bp_k, fin_k = _kernel_plane(g1, g2, model, settings)
    bp_s, fin_s = _scan_plane(g1, g2, model, settings)
    assert np.array_equal(bp_k, bp_s)
    assert np.array_equal(fin_k, fin_s)

    path_k, end_k = sheared_align_path(g1, g2, model, settings)
    path_o, end_o = PairAligner(g1, g2, model, settings).align()
    assert _path_states(path_k) == _path_states(path_o)
    assert end_k.score == pytest.approx(end_o.score, rel=1e-4)


def test_pallas_banded_matches_full():
    """A generous band around the main diagonal (as masks over the full
    width) must not change the optimal path of a near-identical pair,
    and its plane must equal the scan core's banded plane."""
    rng = np.random.default_rng(7)
    s1, s2 = _random_pair(rng, 120, 120, sub=0.05)
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    settings = AlignSettings()

    L = g1.num_sites() - 1
    upper = np.maximum(np.arange(L) - 20, 0)
    lower = np.minimum(np.arange(L) + 20, g2.num_sites() - 2)
    bp_k, fin_k = _kernel_plane(g1, g2, model, settings, (upper, lower))
    bp_s, fin_s = _scan_plane(g1, g2, model, settings, (upper, lower))
    assert np.array_equal(bp_k, bp_s)
    assert np.array_equal(fin_k, fin_s)
    path_b, end_b = sheared_align_path(g1, g2, model, settings,
                                       band=(upper, lower))
    path_f, end_f = sheared_align_path(g1, g2, model, settings)
    assert _path_states(path_b) == _path_states(path_f)
    assert end_b.score == pytest.approx(end_f.score, rel=1e-6)


def test_pallas_banded_fallback():
    """An impossibly thin band that dead-ends must trigger the
    full-matrix retry (viterbi_alignment.cpp:298-317)."""
    rng = np.random.default_rng(9)
    s1, s2 = _random_pair(rng, 60, 60)
    # shift right sequence so the main diagonal band misses the path
    s2 = "ACGTACGTACGTACGTACGTACGTACGT" + s2
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    model = ModelFactory(alph.DNA).alignment_model(0.3)
    settings = AlignSettings()

    L = g1.num_sites() - 1
    R = g2.num_sites() - 1
    # band that excludes the end corner entirely
    upper = np.zeros(L, np.int32)
    lower = np.minimum(np.arange(L) // 10, R - 1).astype(np.int32)
    _bp, fin = _kernel_plane(g1, g2, model, settings, (upper, lower))
    assert not np.isfinite(fin).any()
    path_b, end_b = sheared_align_path(g1, g2, model, settings,
                                       band=(upper, lower))
    path_f, end_f = sheared_align_path(g1, g2, model, settings)
    assert _path_states(path_b) == _path_states(path_f)


# ----------------------------------------------------------------------
# windowed band fill: the kernel over band_schedule's moving window

def _related_pair(rng, n, sub=0.05, indel=0.02):
    base = rng.choice(list("ACGT"), size=n)
    out = []
    i = 0
    while i < n:
        r = rng.random()
        if r < indel / 2:
            i += rng.integers(1, 4)       # deletion
        elif r < indel:
            out.extend(rng.choice(list("ACGT"), size=int(rng.integers(1, 4))))
        elif rng.random() < sub:
            out.append(rng.choice(list("ACGT")))
            i += 1
        else:
            out.append(base[i])
            i += 1
    return "".join(base), "".join(out)


def _window_planes(g1, g2, model, settings, upper, lower):
    """(kernel bp, kernel corner, scan bp, scan corner) of the windowed
    band fill, the scan plane cut to the kernel's diagonals."""
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    ilo, w = band_schedule(upper, lower, L, R)
    W = hopper.window_rows(w)
    job = hopper.linear_job(g1, g2, model, settings, L, R,
                            band=(upper, lower))
    bp_k, fin_k = hopper.linear_fill([job], L + R - 1, W, ilo=ilo)
    core, args, ilo_s, _inp = banded_fill_args(g1, g2, model, settings,
                                               upper, lower, np.float32)
    assert np.array_equal(ilo, ilo_s)
    bp_s, fin_s = core(*args)
    return (bp_k[0], fin_k[0],
            np.asarray(bp_s).view(np.uint8)[:L + R - 1], np.asarray(fin_s))


def _same_window_plane(bp_k, bp_s):
    """Equal on the common width; the wider one holds only NONE codes
    beyond it."""
    Wc = min(bp_k.shape[1], bp_s.shape[1])
    return (np.array_equal(bp_k[:, :Wc], bp_s[:, :Wc])
            and np.all(bp_k[:, Wc:] == 0x3F)
            and np.all(bp_s[:, Wc:] == 0x3F))


def test_pallas_windowed_banded_matches_scan_and_full():
    """The windowed band fill must reproduce the scan core's plane and
    corner exactly (and the full sheared DP's path when the band holds
    the optimal path)."""
    from pagan2_tpu.align.anchors import define_tunnel_for_graphs
    rng = np.random.default_rng(21)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    settings = AlignSettings()
    for t in range(3):
        s1, s2 = _related_pair(rng, 500)
        g1 = build_leaf_graph(s1, alph.DNA)
        g2 = build_leaf_graph(s2, alph.DNA)
        upper, lower, _bl, cov = define_tunnel_for_graphs(g1, g2)
        assert cov < 0.6
        bp_k, fin_k, bp_s, fin_s = _window_planes(g1, g2, model, settings,
                                                  upper, lower)
        assert _same_window_plane(bp_k, bp_s), f"trial {t}"
        assert np.array_equal(fin_k, fin_s), f"trial {t}"
        path_p, end_p = banded_align_path(g1, g2, model, settings,
                                          upper, lower)
        g1f = build_leaf_graph(s1, alph.DNA)
        g2f = build_leaf_graph(s2, alph.DNA)
        path_f, end_f = sheared_align_path(g1f, g2f, model, settings,
                                           dtype=np.float32)
        assert _path_states(path_p) == _path_states(path_f), f"trial {t}"


def test_pallas_windowed_banded_wide_window():
    """A window several hundred rows wide (many cells per thread) must
    match the scan core and the full fill."""
    rng = np.random.default_rng(22)
    s1, s2 = _related_pair(rng, 400, sub=0.1, indel=0.05)
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    L = g1.num_sites() - 1
    R = g2.num_sites() - 1
    upper = np.maximum(np.arange(L) - 150, 0).astype(np.int32)
    lower = np.minimum(np.arange(L) + 150, R - 1).astype(np.int32)
    bp_k, fin_k, bp_s, fin_s = _window_planes(g1, g2, model,
                                              AlignSettings(), upper,
                                              lower)
    assert bp_k.shape[1] > 128
    assert _same_window_plane(bp_k, bp_s)
    assert np.array_equal(fin_k, fin_s)
    path_p, end_p = banded_align_path(g1, g2, model, AlignSettings(),
                                      upper, lower)
    path_f, end_f = sheared_align_path(g1, g2, model, AlignSettings())
    assert _path_states(path_p) == _path_states(path_f)
    assert end_p.score == pytest.approx(end_f.score, rel=1e-5)


def test_pallas_windowed_banded_pair_end():
    """Pair-end break penalties ride the packed row/column vectors; the
    band fill must match the scan cores exactly."""
    from dataclasses import replace
    from pagan2_tpu.align.oracle import mark_no_gap_penalty_sites
    rng = np.random.default_rng(23)
    r1 = "".join(rng.choice(list("ACGT"), 25))
    r2 = "".join(rng.choice(list("ACGT"), 25))
    mid = "".join(rng.choice(list("ACGT"), 40))
    ref = r1 + mid + r2

    def build():
        gl = build_leaf_graph(ref, alph.DNA)
        seq = r1 + "0" + r2
        gr = build_leaf_graph(seq, alph.DNA, quality="I" * len(seq))
        xr = mark_no_gap_penalty_sites(gl)
        yr = mark_no_gap_penalty_sites(gr)
        s = replace(AlignSettings(), pair_end_reads=True,
                    x_read1_length=xr, y_read1_length=yr)
        return gl, gr, s

    model = ModelFactory(alph.DNA).alignment_model(0.2)
    gl, gr, s = build()
    L = gl.num_sites() - 1
    R = gr.num_sites() - 1
    upper = np.zeros(L, np.int32)
    lower = np.full(L, R - 1, np.int32)     # full band: pure kernel test
    bp_k, fin_k, bp_s, fin_s = _window_planes(gl, gr, model, s, upper,
                                              lower)
    assert _same_window_plane(bp_k, bp_s)
    assert np.array_equal(fin_k, fin_s)
    path_p, end_p = banded_align_path(gl, gr, model, s, upper, lower)
    gl2, gr2, s2 = build()
    path_s, end_s = sheared_align_path(gl2, gr2, model, s2,
                                       dtype=np.float32)
    assert _path_states(path_p) == _path_states(path_s)
    assert end_p.score == pytest.approx(end_s.score, rel=1e-5)


def test_pallas_windowed_banded_fallback():
    """A band that cannot reach the end corner falls back to the full
    sheared fill (viterbi_alignment.cpp:298-317)."""
    rng = np.random.default_rng(24)
    s1 = "".join(rng.choice(list("ACGT"), 80))
    s2 = "ACGTACGTACGTACGTACGT" + s1
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    settings = AlignSettings()
    L = g1.num_sites() - 1
    upper = np.zeros(L, np.int32)
    lower = np.full(L, 3, np.int32)
    path_b, end_b = banded_align_path(g1, g2, model, settings,
                                      upper, lower)
    g1f = build_leaf_graph(s1, alph.DNA)
    g2f = build_leaf_graph(s2, alph.DNA)
    path_f, end_f = sheared_align_path(g1f, g2f, model, settings,
                                       dtype=np.float32)
    assert _path_states(path_b) == _path_states(path_f)
    assert end_b.score == pytest.approx(end_f.score, rel=1e-5)


def test_packed_bp_matches_unpack():
    """The kernel's uint8 plane decodes through _ShearedCells to the
    same pointers as the scan core's int8 plane, for every cell."""
    from pagan2_tpu.align.settings import M_MAT, X_MAT, Y_MAT
    rng = np.random.default_rng(0)
    s1, s2 = _random_pair(rng, 30, 27)
    g1 = build_leaf_graph(s1, alph.DNA)
    g2 = build_leaf_graph(s2, alph.DNA)
    model = ModelFactory(alph.DNA).alignment_model(0.3)
    bp_k, _ = _kernel_plane(g1, g2, model, AlignSettings())
    bp_s, _ = _scan_plane(g1, g2, model, AlignSettings())
    ck = _ShearedCells(bp_k, g1, g2)
    cs = _ShearedCells(bp_s.view(np.int8), g1, g2)
    for i in range(1, g1.num_sites() - 1):
        for j in range(1, g2.num_sites() - 1):
            for m in (M_MAT, X_MAT, Y_MAT):
                a, b = ck.cell(m, i, j), cs.cell(m, i, j)
                assert (a.matrix, a.x_ind, a.y_ind, a.x_edge_ind,
                        a.y_edge_ind) == (b.matrix, b.x_ind, b.y_ind,
                                          b.x_edge_ind, b.y_edge_ind)
