"""bench.py's end-to-end cells at CPU scale, as tests: pileup,
progressive family, megabase anchoring + band fill.  A change to a
fill or its compile keys cannot land without driving the paths these
cells use.  Deselect with `-m "not e2e"` when iterating on something
unrelated.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

pytestmark = pytest.mark.e2e


def test_bench_pileup_e2e_cpu():
    from bench import bench_pileup_e2e
    dt, desc = bench_pileup_e2e(full=False)
    assert dt > 0 and "placed" in desc
    # amplicon-style reads all overlap the first read, so every read
    # must place; a regression that crashes the backtrack or discards
    # reads fails here
    assert "6x96bp 454-style reads, 6 placed" in desc, desc
    assert "consensus 0bp" not in desc, desc


def test_bench_family_e2e_cpu():
    from bench import bench_family_e2e
    dt, desc = bench_family_e2e(full=False)
    assert dt > 0 and "progressive family" in desc


def test_bench_megabase_cpu():
    import numpy as np
    from bench import bench_megabase
    from pagan2_tpu.models import ModelFactory, alphabets as alph
    from pagan2_tpu.align import AlignSettings
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    ms, desc, prep = bench_megabase(np.random.default_rng(0), model,
                                    AlignSettings(), full=False)
    assert ms > 0 and "in-band" in desc
    # the prep breakdown must be reported and account for the total
    assert set(prep) == {"build_s", "anchor_scan_s", "band_smooth_s",
                         "total_s"}
    assert prep["total_s"] >= prep["build_s"]
