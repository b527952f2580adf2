"""Scaling-efficiency harness: jobs/s at 1 device vs N devices (and,
with --coordinator, N processes x M devices — the BASELINE.json
"scaling efficiency at 2 hosts" measurement).

Runs the SAME bucket of independent pairwise jobs through the batched
executor unsharded and sharded over a jobs mesh, and reports

    {"jobs_per_s_1dev": A, "jobs_per_s_mesh": B, "n_devices": N,
     "efficiency": B / (A * N)}

On real hardware B approaches A*N for generations that fill the
mesh (each device fills its own job slice; the only overheads are the
sharded dispatch and the result allgather). On the CPU backend with
virtual devices the number is meaningless (all "devices" share the
same cores) — run this on hardware.

Usage (from the repository root):
  python tools/bench_scaling.py [N_JOBS] [LEN]
  # several processes: one per card, each pinned to its own card
  # (a JAX process reserves most of a card's memory when it starts)
  for r in 0 1 2 3; do
    python tools/bench_scaling.py --coordinator localhost:1234 \
        --num-processes 4 --process-id $r --local-device $r &
  done; wait
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_jobs", nargs="?", type=int, default=16)
    ap.add_argument("length", nargs="?", type=int, default=2047)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-device", type=int, default=None,
                    help="local card this process drives")
    args = ap.parse_args()

    import jax
    if args.coordinator:
        from pagan2_tpu.parallel.multihost import init_multihost
        init_multihost(args.coordinator, args.num_processes,
                       args.process_id, args.local_device)
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import ModelFactory, alphabets as alph
    from pagan2_tpu.align import AlignSettings
    from pagan2_tpu.parallel import executor

    n_dev = len(jax.devices())
    rng = np.random.default_rng(0)
    mf = ModelFactory(alph.DNA)
    model = mf.alignment_model(0.3)

    def jobs():
        out = []
        for t in range(args.n_jobs):
            base = rng.choice(list("ACGT"), size=args.length)
            s1 = "".join(base)
            mut = base.copy()
            idx = rng.random(args.length) < 0.1
            mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
            out.append(executor.PairJob(
                left=build_leaf_graph(s1, alph.DNA),
                right=build_leaf_graph("".join(mut), alph.DNA),
                model=model, settings=AlignSettings()))
        return out

    def run(mesh):
        # warmup/compile
        executor.execute_pair_jobs(jobs(), mesh=mesh,
                                   dtype=np.float32)
        t0 = time.perf_counter()
        executor.execute_pair_jobs(jobs(), mesh=mesh,
                                   dtype=np.float32)
        return args.n_jobs / (time.perf_counter() - t0)

    if args.coordinator:
        from pagan2_tpu.parallel.multihost import global_jobs_mesh
        mesh = global_jobs_mesh()
    else:
        mesh = executor.make_jobs_mesh(n_dev)
    a = run(None)
    b = run(mesh)
    eff = b / (a * n_dev)
    import json
    print(json.dumps({"jobs_per_s_1dev": round(a, 3),
                      "jobs_per_s_mesh": round(b, 3),
                      "n_devices": n_dev,
                      "efficiency": round(eff, 3)}))


if __name__ == "__main__":
    main()
