"""The fill policy (pagan2_tpu/align/backend.py), the kernel wrappers'
tiling and input checks, the compile-cache location, and — on an
NVIDIA GPU only — the CUDA kernels against the scan cores and the host
oracle."""
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from pagan2_tpu.align import backend, hopper
from pagan2_tpu.align.backend import KERNEL, SCAN, fill_impl

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))


def _dev(platform):
    return SimpleNamespace(platform=platform)


@pytest.mark.parametrize("kind", ["linear", "band", "fanin"])
def test_cpu_fills_take_the_scan_cores(kind):
    assert fill_impl(kind) == SCAN
    assert fill_impl(kind, device=_dev("cpu")) == SCAN


@pytest.mark.parametrize("kind", ["linear", "band", "fanin"])
def test_gpu_fills_take_the_kernels(kind):
    assert fill_impl(kind, device=_dev("gpu")) == KERNEL


def test_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="no pairwise DP fill"):
        fill_impl("linear", device=_dev("metal"))
    with pytest.raises(RuntimeError, match="no pairwise DP fill"):
        fill_impl("fanin", overcap=True, device=_dev("rocm"))


def test_sharded_and_overcap_fills_take_the_scan_cores():
    gpu = _dev("gpu")
    assert fill_impl("linear", sharded=True, device=gpu) == SCAN
    assert fill_impl("fanin", overcap=True, device=gpu) == SCAN
    from pagan2_tpu.align.viterbi_fanin import fanin_overcap, K_CAP
    assert fanin_overcap(K_CAP + 1, 2, 2, 2)
    assert fanin_overcap(2, 2, 9, 9)          # bucketed 12 x 12 > 64
    assert not fanin_overcap(K_CAP, K_CAP, 3, 3)


def test_fill_counts_name_implementation_and_platform():
    from pagan2_tpu.parallel import executor
    executor.reset_stats()
    backend.count_fill(KERNEL, _dev("gpu"), 3)
    backend.count_fill(SCAN)
    assert dict(backend.FILL_COUNTS) == {"kernel@gpu": 3, "scan@cpu": 1}
    executor.reset_stats()
    assert not backend.FILL_COUNTS


def test_linear_tiling():
    # a fixed window wider than one block splits into T_MAX-row blocks
    T, nblk, smem = hopper.linear_tiling(65536, moving=False)
    assert (T, nblk, smem) == (hopper.T_MAX, 65536 // hopper.T_MAX, 1)
    # a moving window always runs in one block, in global memory when
    # its state outgrows the shared-memory budget
    T, nblk, smem = hopper.linear_tiling(8192, moving=True)
    assert (T, nblk, smem) == (8192, 1, 0)
    assert hopper.linear_tiling(2048, moving=False) == (2048, 1, 1)


def test_fanin_fill_rejects_a_receding_window():
    inp = dict(L=8, R=8, OL=1, OR=1, loff=np.ones((8, 1), np.int32),
               roff=np.ones((8, 1), np.int32),
               llw=np.zeros((8, 1)), lopen=np.zeros((8, 1)),
               rlw=np.zeros((8, 1)), ropen=np.zeros((8, 1)),
               gext_i=np.zeros(8), gext_j=np.zeros(8),
               lstates=np.zeros(8, np.int32), rstates=np.zeros(8, np.int32),
               log_score=np.zeros((4, 4)), lng=0.0, lgo=0.0)
    ilo = np.zeros(15, np.int32)
    ilo[5:] = 2
    ilo[9] = 1
    with pytest.raises(ValueError, match="never decrease"):
        hopper.fanin_fill([inp], 8, 8, 1, 1, W=4, ilo=ilo)
    with pytest.raises(ValueError, match="exceeds"):
        hopper.fanin_fill([inp], 8, 8, 1, 1, W=16)


def test_linear_fill_rejects_a_jumping_window():
    job = dict(rowf=np.zeros((3, 8), np.float32),
               rowi=np.zeros((3, 8), np.int32),
               colf=np.zeros((3, 8), np.float32),
               coli=np.zeros(8, np.int32),
               tab=np.zeros(16, np.float32),
               fsc=np.zeros(2, np.float32), isc=np.array([8, 8], np.int32))
    ilo = np.array([0, 0, 2, 3], np.int32)
    with pytest.raises(ValueError, match="advance by 0 or 1"):
        hopper.linear_fill([job], 4, 32, ilo=ilo)


def test_compile_cache_location(monkeypatch):
    import jax
    from pagan2_tpu import cli
    was = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        cli.configure_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            cli.__file__)))
        assert jax.config.jax_compilation_cache_dir == \
            os.path.join(root, ".jax_cache")
        # a directory from the environment is JAX's own; the program
        # sets no other
        jax.config.update("jax_compilation_cache_dir", "/from/env")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
        cli.configure_compile_cache()
        assert jax.config.jax_compilation_cache_dir == "/from/env"
    finally:
        jax.config.update("jax_compilation_cache_dir", was)


def test_linear_parity_and_readback_on_emulated_kernel(emulated_kernels):
    import bench
    r = bench.parity_linear(B=2, N=150)
    assert r["bp_identical"], r
    assert r["score_max_rel"] == 0.0, r
    sec, nbytes = r["readback"]
    assert nbytes == 2 * (2 * 256 - 1) * 256 and sec >= 0.0   # Lp = 256


def test_fanin_band_parity_on_emulated_kernel(emulated_kernels):
    """The chip's anchored fan-in case at a CPU size: the windowed
    kernel wrapper equals the windowed scan core, and the single-pair
    path completes through it."""
    import bench
    backend.FILL_COUNTS.clear()
    r = bench.parity_fanin_band(N=700)
    assert r["bp_identical"], r
    assert r["score_max_rel"] == 0.0, r
    assert np.isfinite(r["path_score"]) and r["path_len"] >= 700
    assert backend.FILL_COUNTS["kernel@cpu"] >= 1
    runs = bench.capped_runs(np.random.default_rng(0), 5000)
    change = np.flatnonzero(runs[1:] != runs[:-1])
    assert len(runs) == 5000 and np.diff(change).max() <= 4


# ----------------------------------------------------------------------
# the CUDA kernels themselves (skip without a GPU)

@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["parity_linear", "parity_fanin"])
def test_kernel_matches_scan_core_on_gpu(gpu, fn):
    import bench
    r = getattr(bench, fn)(B=3, N=300)
    assert r["bp_identical"], r
    assert r["score_max_rel"] == 0.0, r


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["parity_band", "parity_fanin_band"])
def test_band_kernel_matches_scan_core_on_gpu(gpu, fn):
    import bench
    r = getattr(bench, fn)(N=20000, p=0.03)
    assert r["bp_identical"], r
    assert r["score_max_rel"] == 0.0, r


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n1,n2", [(0, 40, 40), (1, 37, 52),
                                        (3, 9, 9)])
def test_kernel_paths_match_oracle_on_gpu(gpu, seed, n1, n2):
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import ModelFactory, alphabets as alph
    from pagan2_tpu.align import AlignSettings
    from pagan2_tpu.align.oracle import PairAligner
    from pagan2_tpu.align.viterbi_sheared import sheared_align_path
    from pagan2_tpu.align.viterbi_fanin import fanin_align_path
    rng = np.random.default_rng(seed)
    s1 = "".join(rng.choice(list("AACCGGTT"), size=n1))
    s2 = "".join(rng.choice(list("AACCGGTT"), size=n2))
    model = ModelFactory(alph.DNA).alignment_model(0.3)
    settings = AlignSettings()

    def sig(path):
        return [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in path]
    for mode454, run in ((False, sheared_align_path),
                         (True, fanin_align_path)):
        g1 = build_leaf_graph(s1, alph.DNA, mode454=mode454)
        g2 = build_leaf_graph(s2, alph.DNA, mode454=mode454)
        backend.FILL_COUNTS.clear()
        path, end = run(g1, g2, model, settings)
        assert backend.FILL_COUNTS["kernel@gpu"] == 1
        opath, oend = PairAligner(g1, g2, model, settings).align()
        assert sig(path) == sig(opath)
        assert end.score == pytest.approx(oend.score, rel=1e-5)
