"""C++ native runtime: build, load, and bit-parity with the Python
fallbacks (pagan2_tpu/native/pagan2_native.cpp)."""
import os

import numpy as np
import pytest

from pagan2_tpu import native


def _have_native():
    return native.get_lib() is not None


pytestmark = pytest.mark.skipif(not _have_native(),
                                reason="native library unavailable")


def _python_anchors(fn, *args):
    """Run the pure-Python fallback by masking the native lib."""
    old = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        return fn(*args)
    finally:
        native._lib, native._tried = old


def test_prefix_anchor_parity():
    from pagan2_tpu.align.anchors import find_prefix_anchors
    rng = np.random.default_rng(0)
    base = rng.choice(list("ACGT"), size=2000)
    s1 = "".join(base)
    s2 = "".join(c if rng.random() > 0.03 else rng.choice(list("ACGT"))
                 for c in base)
    nat = find_prefix_anchors(s1, s2, 30)
    py = _python_anchors(find_prefix_anchors, s1, s2, 30)
    assert [(h.start_site_1, h.start_site_2, h.length) for h in nat] == \
           [(h.start_site_1, h.start_site_2, h.length) for h in py]
    assert nat, "expected anchors on a 3%-divergent pair"


def test_kmer_anchor_parity():
    from pagan2_tpu.align.anchors import find_kmer_anchors
    rng = np.random.default_rng(1)
    base = rng.choice(list("ACGT"), size=3000)
    s1 = "".join(base)
    s2 = "".join(c if rng.random() > 0.05 else rng.choice(list("ACGT"))
                 for c in base)
    nat = find_kmer_anchors(s1, s2)
    py = _python_anchors(find_kmer_anchors, s1, s2)
    assert [(h.start_site_1, h.start_site_2, h.length) for h in nat] == \
           [(h.start_site_1, h.start_site_2, h.length) for h in py]
    assert nat


def test_kmer_anchor_parity_protein():
    from pagan2_tpu.align.anchors import find_kmer_anchors
    rng = np.random.default_rng(2)
    aas = list("ARNDCQEGHILKMFPSTWYV")
    base = rng.choice(aas, size=800)
    s1 = "".join(base)
    s2 = "".join(c if rng.random() > 0.05 else rng.choice(aas)
                 for c in base)
    nat = find_kmer_anchors(s1, s2, k=8)
    py = _python_anchors(find_kmer_anchors, s1, s2, 8)
    assert [(h.start_site_1, h.start_site_2, h.length) for h in nat] == \
           [(h.start_site_1, h.start_site_2, h.length) for h in py]


def test_maxmin_subsample_matches_python_greedy():
    rng = np.random.default_rng(3)
    pts = rng.random((40, 2))
    mat = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1))
    keep = native.maxmin_subsample(mat, 10, 0)
    assert keep is not None and keep.sum() == 10
    # python greedy farthest-point from the same start
    kept = [0]
    rest = list(range(1, 40))
    while len(kept) < 10:
        nxt = max(rest, key=lambda i: min(mat[i, k] for k in kept))
        kept.append(nxt)
        rest.remove(nxt)
    assert set(np.nonzero(keep)[0]) == set(kept)


def test_native_speedup_prefix():
    """The native suffix sort must beat the O(n^2)-memory Python path
    comfortably on mid-size input."""
    import time
    from pagan2_tpu.align.anchors import find_prefix_anchors
    rng = np.random.default_rng(4)
    base = rng.choice(list("ACGT"), size=20000)
    s1 = "".join(base)
    s2 = "".join(c if rng.random() > 0.02 else rng.choice(list("ACGT"))
                 for c in base)
    t0 = time.perf_counter()
    nat = find_prefix_anchors(s1, s2, 30)
    t_nat = time.perf_counter() - t0
    assert nat
    assert t_nat < 5.0
