"""Multi-HOST execution proof (SURVEY §2.5's north star beyond one
host): two real OS processes join one jax.distributed runtime over the
loopback network, the executor runs a generation of batched pair jobs
sharded over the GLOBAL 8-device jobs mesh (4 CPU devices per process),
and the gathered results must be identical across processes AND to a
plain single-process run. The reference has nothing beyond
shared-memory threads (node.cpp:196-345)."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_mesh_matches_single(tmp_path):
    worker = os.path.join(os.path.dirname(__file__),
                          "multihost_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(worker))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    # the workers set their own JAX env; scrub the test session's
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    r0 = json.load(open(tmp_path / "proc0.json"))
    r1 = json.load(open(tmp_path / "proc1.json"))
    assert r0["n_devices"] == 8
    # every process gathered the SAME full result set
    assert r0["keys"] == r1["keys"]
    assert r0["stats"]["batched_jobs"] == 8

    # single-process reference run (same seed, same jobs)
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import ModelFactory, alphabets as alph
    from pagan2_tpu.align import AlignSettings
    from pagan2_tpu.parallel import executor
    rng = np.random.default_rng(42)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)
    jobs = []
    for t in range(8):
        base = rng.choice(list("ACGT"), size=60)
        s1 = "".join(base)
        mut = base.copy()
        idx = rng.random(60) < 0.15
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        jobs.append(executor.PairJob(
            left=build_leaf_graph(s1, alph.DNA),
            right=build_leaf_graph("".join(mut), alph.DNA),
            model=model, settings=AlignSettings()))
    results = executor.execute_pair_jobs(jobs, dtype=np.float64)
    keys = [[int(anc.states[i]) for i in range(anc.num_sites())]
            for anc, _e in results]
    assert keys == r0["keys"], \
        "2-process global-mesh result != single-process result"
