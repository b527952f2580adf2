"""Cold-start story: the persistent XLA compile cache makes a SECOND
fresh process on the same workload compile (almost) nothing — the
framework's answer to the reference's pre-compiled binary starting
instantly (main.cpp:42).  The cache lives where
JAX_COMPILATION_CACHE_DIR says, and nowhere else.
"""
import os
import subprocess
import sys
import time

import pytest


def _run_pileup(tmp_path, cache_dir, tag):
    reads = (">r0\nACGGGGTACGTACGTTGCA\n"
             ">r1\nACGGGTACGTACGTTGCA\n"
             ">r2\nGGTACGTACGTTGCAACGT\n")
    fas = tmp_path / f"reads_{tag}.fas"
    fas.write_text(reads)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache_dir),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))) + ":"
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pagan2_tpu", "--pileup",
         "--homopolymer", "-q", str(fas),
         "-o", str(tmp_path / f"out_{tag}")],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return time.perf_counter() - t0


@pytest.mark.e2e
def test_second_fresh_process_compiles_nothing(tmp_path):
    cache = tmp_path / "jaxcache"
    cache.mkdir()
    _run_pileup(tmp_path, cache, "cold")
    after_first = set(os.listdir(cache))
    assert after_first, "first run persisted no compiled kernels"
    _run_pileup(tmp_path, cache, "warm")
    new = set(os.listdir(cache)) - after_first
    # every XLA compile with min_compile_time 0 writes a cache entry;
    # zero new entries == the second fresh process was served entirely
    # from the persistent cache
    assert not new, f"second process recompiled {len(new)} kernels: " \
                    f"{sorted(new)[:5]}"
