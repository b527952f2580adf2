"""Batched generation executor: one kernel launch per generation bucket.

The reference runs independent guide-tree nodes concurrently on CPU
threads (boost queue node.cpp:273-345, OpenMP waves node.cpp:227-269).
Here one generation's independent pairwise jobs are batched into a
single batched wavefront launch (jobs stacked on the batch
axis, padded to shared shape buckets) and shards the batch over the
`jobs` axis of a device mesh. Backtrack and ancestral-graph construction
stay per-job on host (O(path) work).

Jobs that cannot batch (graph fan-in beyond the kernel cap, sampling /
full-probability, thin-band megabase pairs that want the windowed
kernel) fall back to `align_pair` one by one — the same dispatch the
sequential pipeline uses.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..align.settings import AlignSettings
from ..utils import log_out

# observability: kernel-launch / job counters (reset per run if
# desired). fill_seconds wraps launch+readback wall time so the CLI's
# --time report can derive a real-run GCUPS figure (in-band cells/s,
# the reference logs only phase clocks, main.cpp:50-63). Single-job
# fills account for themselves via align._acct; shardband_fills counts
# band-axis-sharded giant-pair fills.
EXEC_STATS = {"launches": 0, "batched_jobs": 0, "single_jobs": 0,
              "batched_cells": 0, "fill_seconds": 0.0,
              "single_fills": 0, "shardband_fills": 0,
              "fanin_batches": 0, "fanin_fp_batches": 0}

# band-axis sharding threshold: a linear-chain pair whose left side has
# at least this many sites (and no thin anchor band) is split over the
# mesh's devices when the generation would otherwise leave them idle
SHARDBAND_MIN_L = 1 << 16


def reset_stats():
    from ..align.backend import FILL_COUNTS
    for k in EXEC_STATS:
        EXEC_STATS[k] = 0
    FILL_COUNTS.clear()


def kernel_key_counts() -> dict:
    """Distinct fan-in scan-core compile keys this process.  The
    K/G/offset bucketing exists to keep these flat as a pileup root's
    fan-in creeps; chip_smoke.py reports them so the compile reuse is
    measured, not assumed."""
    from ..align import viterbi_fanin as vf
    return {"fanin_scan": len(vf.FILL_KEYS)}


def _is_device_oom(e: Exception) -> bool:
    import jax
    return (isinstance(e, jax.errors.JaxRuntimeError)
            and "RESOURCE_EXHAUSTED" in str(e))


@dataclass
class PairJob:
    """One pairwise alignment job (a ready tree node, a placement
    candidate...). `key` is opaque caller context."""
    left: Any
    right: Any
    model: Any
    settings: AlignSettings
    left_branch_length: float = 0.0
    right_branch_length: float = 0.0
    is_reads_sequence: bool = False
    compute_consensus: bool = False
    key: Any = None
    # filled by planning
    band: Any = None
    skipped: bool = False


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else int(np.prod(list(mesh.shape.values())))


def make_jobs_mesh(n_devices: int | None = None):
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    n = n_devices or len(devs)
    n = min(n, len(devs))
    return Mesh(np.array(devs[:n]), ("jobs",))


def prepare_job(left, right, model, settings: AlignSettings,
                dtype=np.float32):
    """Per-job device input dict for the generic wavefront fill (kept
    for __graft_entry__'s single-chip compile check)."""
    from ..align.viterbi_jax import _prepare
    return _prepare(left, right, model, settings, dtype)


# ----------------------------------------------------------------------
def _plan_job(job: PairJob):
    """Anchor/band planning mirroring align_pair's gate: returns
    'batch' (shared sheared launch), 'fanin' (shared ring-buffer
    launch), 'banded' (single windowed kernel), or 'single'
    (align_pair fallback)."""
    from ..align import plan_band
    from ..align.viterbi_sheared import is_linear_chain, _bucket

    s = job.settings
    linear = is_linear_chain(job.left) and is_linear_chain(job.right)
    if s.compute_full_score or s.sample_path or \
            s.sample_additional_paths > 0:
        # full-probability / sampling jobs batch their scaled fwd/bwd
        # plane fills (one vmapped launch per bucket): linear chains
        # via the sheared cores, fan-in graphs via the gather cores.
        # Pair-end jobs stay single (align_pair strips the break
        # markers and still runs on device).
        if s.pair_end_reads:
            return "single"
        return "batch_fp" if linear else "fanin_fp"
    if s.pair_end_reads:
        return "single"
    gate = s.anchor_min_sites
    if not linear:
        from ..align.viterbi_fanin import (fanin_stats, K_CAP, G_CAP,
                                           scan_core_bound,
                                           SCAN_ANCHOR_MIN_SITES)
        KL, OL = fanin_stats(job.left)
        KR, OR = fanin_stats(job.right)
        if KL > K_CAP or KR > K_CAP or OL + OR > G_CAP:
            return "single"
        if scan_core_bound(KL, OL, KR, OR):
            # wide fan-in pair: anchor from a much smaller size (the
            # reference anchors every pair)
            gate = min(gate, SCAN_ANCHOR_MIN_SITES)
    if job.band is None and s.use_anchors and \
            min(job.left.num_sites(), job.right.num_sites()) > gate:
        job.band, job.skipped = plan_band(job.left, job.right, s)
        if job.skipped:
            return "skipped"
    if job.band is not None:
        from ..align.viterbi_banded import band_windows
        L = job.left.num_sites() - 1
        R = job.right.num_sites() - 1
        _ilo, Wreal = band_windows(job.band[0], job.band[1], L, R)
        if _bucket(Wreal) * 2 <= _bucket(R):
            return "banded" if linear else "single"
    return "batch" if linear else "fanin"


def _job_settings(job: PairJob) -> AlignSettings:
    """Per-job effective settings, mirroring align_pair's widening:
    reads jobs AND --keep-all-edges jobs take the permissive skip
    limits (viterbi_alignment.cpp:206) — batched launches must match
    the single-dispatch path or output depends on batch width."""
    s = job.settings
    if job.is_reads_sequence or s.keep_all_edges:
        s = s.for_reads()
    return s


def _run_single(job: PairJob, engine: str):
    from ..align import align_pair
    EXEC_STATS["single_jobs"] += 1
    # align_pair applies the same widening internally and forwards
    # is_reads_sequence into the ancestral build (anc.is_read_sequence
    # must not depend on whether the job batched)
    return align_pair(job.left, job.right, job.model, job.settings,
                      job.left_branch_length, job.right_branch_length,
                      is_reads_sequence=job.is_reads_sequence,
                      engine=engine, band=job.band,
                      compute_consensus=job.compute_consensus)


def _run_shardband(job: PairJob, mesh, dtype):
    """Band-axis-sharded fill for one giant linear pair: the lane axis
    of the sheared wavefront splits over the mesh with halo exchange
    (viterbi_shardband; bit-identical to the 1-device kernel). This is
    SURVEY §2.5's north star as a production dispatch: one pair too big
    for one device's turn rides all devices."""
    import time
    from ..align import _acct, _band_cells
    from ..align.ancestral import build_ancestral_graph
    from ..align.viterbi_shardband import shardband_align_path
    t0 = time.perf_counter()
    settings = _job_settings(job)
    # the executor mesh axis is `jobs`; rebuild over the same devices
    # with the `band` axis the shard_map fill partitions on
    from jax.sharding import Mesh
    band_mesh = Mesh(mesh.devices.reshape(-1), ("band",))
    path, end = shardband_align_path(
        job.left, job.right, job.model, settings, band_mesh,
        job.left_branch_length, job.right_branch_length,
        band=job.band, dtype=dtype)
    L = job.left.num_sites() - 1
    R = job.right.num_sites() - 1
    _acct(t0, _band_cells(job.band, L, R))
    from ..align.backend import count_fill
    count_fill("scan", mesh.devices.flat[0])
    EXEC_STATS["shardband_fills"] += 1
    EXEC_STATS["launches"] += 1
    log_out("shard_map band-axis fill: %dx%d over %d devices"
            % (L, R, int(np.prod(list(mesh.shape.values())))), 2)
    anc = build_ancestral_graph(job.left, job.right, path, job.model,
                                settings,
                                job.left_branch_length,
                                job.right_branch_length,
                                job.is_reads_sequence,
                                compute_consensus=job.compute_consensus)
    return anc, end


def _run_shardband_fanin(job: PairJob, mesh, dtype):
    """Band-axis-sharded ring fill for one giant FAN-IN pair
    (454/homopolymer read graphs, deep ancestors with indel bridges):
    the one-hot fan-in recurrence with the diagonal ring lane-sharded
    over the mesh, bit-identical to the scan core. Raises ValueError
    past the one-hot caps (the caller falls back to the windowed
    gather core)."""
    import time
    from ..align import _acct, _band_cells
    from ..align.ancestral import build_ancestral_graph
    from ..align.viterbi_shardband import shardband_fanin_align_path
    t0 = time.perf_counter()
    settings = _job_settings(job)
    from jax.sharding import Mesh
    band_mesh = Mesh(mesh.devices.reshape(-1), ("band",))
    path, end = shardband_fanin_align_path(
        job.left, job.right, job.model, settings, band_mesh,
        job.left_branch_length, job.right_branch_length,
        band=job.band, dtype=dtype)
    L = job.left.num_sites() - 1
    R = job.right.num_sites() - 1
    _acct(t0, _band_cells(job.band, L, R))
    from ..align.backend import count_fill
    count_fill("scan", mesh.devices.flat[0])
    EXEC_STATS["shardband_fills"] += 1
    EXEC_STATS["launches"] += 1
    log_out("shard_map band-axis fan-in fill: %dx%d over %d devices"
            % (L, R, int(np.prod(list(mesh.shape.values())))), 2)
    anc = build_ancestral_graph(job.left, job.right, path, job.model,
                                settings,
                                job.left_branch_length,
                                job.right_branch_length,
                                job.is_reads_sequence,
                                compute_consensus=job.compute_consensus)
    return anc, end


# ----------------------------------------------------------------------
def _stack_sheared(jobs: list[PairJob], Lp: int, Rp: int, pad_to: int,
                   dtype):
    """Stack per-job sheared inputs to batch arrays (padding the batch
    with copies of job 0 so it divides the mesh)."""
    import jax.numpy as jnp
    from ..align.viterbi_sheared import (prepare_sheared,
                                         shear_device_inputs)

    per_job = []
    inputs = []
    for job in jobs:
        s = _job_settings(job)
        inp = prepare_sheared(job.left, job.right, job.model, s,
                              dtype=dtype)
        upper = job.band[0] if job.band else None
        lower = job.band[1] if job.band else None
        per_job.append(shear_device_inputs(inp, Lp=Lp, Rp=Rp,
                                           upper=upper, lower=lower))
        inputs.append(inp)
    while len(per_job) < pad_to:
        per_job.append(per_job[0])
    # per-job prep is numpy; one np.stack + one host->device transfer
    # per argument (the previous jnp.stack of per-job device arrays
    # dominated end-to-end time on many-small-job generations)
    n_vec = 7   # ms_sh, gj_rext, orp_rext, rw_rext, gext_i, open_l, lw
    args = [jnp.asarray(np.stack([p[i] for p in per_job]))
            for i in range(n_vec)]
    args.append(jnp.asarray(np.asarray([p[7] for p in per_job])))   # lng
    args.append(jnp.asarray(np.asarray([p[8] for p in per_job])))   # lgo
    args.append(jnp.asarray(np.asarray([p[9] for p in per_job])))   # Ldp
    args.append(jnp.asarray(np.asarray([p[10] for p in per_job])))  # Rdp
    args.append(jnp.asarray(np.stack([p[11] for p in per_job])))    # lo
    args.append(jnp.asarray(np.stack([p[12] for p in per_job])))    # hi
    return args, inputs


def _finish_sheared(job: PairJob, inp, bp, final, engine: str):
    """Host backtrack + ancestral build for one batched job."""
    from ..align import align_pair
    from ..align.ancestral import build_ancestral_graph
    from ..align.oracle import PathPtr
    from ..align.viterbi_sheared import _ShearedCells, _end_corner_linear
    from ..align.viterbi_jax import _backtrack_arrays

    final = np.asarray(final)
    if job.band is not None and not np.isfinite(final).any():
        # anchored fill dead-ended: full-matrix retry
        # (viterbi_alignment.cpp:298-317)
        job.band = None
        return _run_single(job, engine)
    settings = _job_settings(job)
    cells = _ShearedCells(bp, job.left, job.right)
    end = _end_corner_linear(final, job.left, job.right, job.model,
                             inp["L"], inp["R"])
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, job.left, job.right,
                             PathPtr(end, True), inp["L"], inp["R"],
                             job.left_branch_length,
                             job.right_branch_length)
    anc = build_ancestral_graph(job.left, job.right, path, job.model,
                                settings,
                                job.left_branch_length,
                                job.right_branch_length,
                                job.is_reads_sequence,
                                compute_consensus=job.compute_consensus)
    return anc, end


# batch size cap: cells per launch (ms_sh f32/f64 dominates the
# footprint; 2^28 cells ~ 2-4 GB through the sheared layout)
MAX_BATCH_CELLS = 1 << 28


def _default_dtype():
    """f64 when jax x64 is on (tests / parity runs), else f32 — avoids
    silent-truncation warning spam under the CLI's default f32 config."""
    import jax
    return np.float64 if jax.config.jax_enable_x64 else np.float32


def execute_pair_jobs(jobs: list[PairJob], engine: str = "auto",
                      mesh=None, dtype=None):
    """Run independent pairwise jobs, batching eligible ones into shared
    kernel launches (one per shape bucket), optionally sharded over the
    mesh's `jobs` axis. Returns [(ancestral_graph, end_ptr)] in job
    order. Skipped jobs (anchoring-coverage heuristic) yield
    (None, None)."""
    if dtype is None:
        dtype = _default_dtype()
    results: list = [None] * len(jobs)
    if engine == "oracle":
        for i, job in enumerate(jobs):
            results[i] = _run_single(job, engine)
        return results

    from ..align.viterbi_sheared import _bucket

    buckets: dict[tuple, list[int]] = {}
    fanin_buckets: dict[tuple, list[int]] = {}
    fp_buckets: dict[tuple, list[int]] = {}
    fanin_fp_buckets: dict[tuple, list[int]] = {}
    for i, job in enumerate(jobs):
        try:
            kind = _plan_job(job)
        except ImportError:
            kind = "single"
        if kind == "skipped":
            results[i] = (None, None)
        elif kind in ("single", "banded"):
            results[i] = _run_single(job, engine)
        else:
            L = job.left.num_sites() - 1
            R = job.right.num_sites() - 1
            key = (_bucket(L), _bucket(R))
            {"batch": buckets, "fanin": fanin_buckets,
             "batch_fp": fp_buckets,
             "fanin_fp": fanin_fp_buckets}[kind].setdefault(
                 key, []).append(i)

    n_shards = _mesh_size(mesh)

    # band-axis sharding: when the generation underfills the mesh and a
    # pair is giant (no thin band — those already took the windowed
    # kernel via 'banded'), split its lane axis over the devices
    # instead of leaving them idle — linear pairs via the sheared fill,
    # fan-in pairs via the ring fill (round-3 hole: only linear could)
    if mesh is not None and n_shards > 1:
        n_batchable = sum(len(v) for v in buckets.values()) + \
            sum(len(v) for v in fanin_buckets.values())
        if n_batchable < n_shards:
            for bkt, runner in ((buckets, _run_shardband),
                                (fanin_buckets, _run_shardband_fanin)):
                for key in list(bkt):
                    keep = []
                    for i in bkt[key]:
                        if jobs[i].left.num_sites() - 1 >= \
                                SHARDBAND_MIN_L:
                            if runner is _run_shardband_fanin:
                                try:
                                    results[i] = runner(jobs[i], mesh,
                                                        dtype)
                                except ValueError:
                                    # fan-in beyond the one-hot caps:
                                    # windowed gather core, unsharded
                                    results[i] = _run_single(jobs[i],
                                                             engine)
                            else:
                                results[i] = runner(jobs[i], mesh,
                                                    dtype)
                        else:
                            keep.append(i)
                    if keep:
                        bkt[key] = keep
                    else:
                        del bkt[key]

    # one dispatch loop per bucket kind: single-job shortcut, then
    # chunking so one launch stays under the cell budget
    for bkt, launcher in ((buckets, _launch_sheared_batch),
                          (fanin_buckets, _launch_fanin_batch),
                          (fp_buckets, _launch_fullprob_batch),
                          (fanin_fp_buckets,
                           _launch_fanin_fullprob_batch)):
        for (Lp, Rp), idxs in sorted(bkt.items()):
            if len(idxs) == 1 and n_shards == 1:
                # no batching win; single dispatch avoids the stack copy
                i = idxs[0]
                results[i] = _run_single(jobs[i], engine)
                continue
            per_job_cells = Lp * Rp
            chunk = max(n_shards,
                        (MAX_BATCH_CELLS // per_job_cells // n_shards)
                        * n_shards or n_shards)
            for c0 in range(0, len(idxs), chunk):
                part = idxs[c0:c0 + chunk]
                try:
                    launcher(jobs, part, results, Lp, Rp, mesh,
                             n_shards, engine, dtype)
                except Exception as e:
                    # a batched launch that runs out of device memory
                    # re-runs its jobs one at a time; anything else is
                    # a fault and raises
                    if not _is_device_oom(e):
                        raise
                    log_out("batched launch out of device memory (%s); "
                            "re-running %d jobs singly" % (e, len(part)),
                            0)
                    for i in part:
                        if results[i] is None:
                            results[i] = _run_single(jobs[i], engine)
    return results


def _launch_sheared_batch(jobs, idxs, results, Lp, Rp, mesh, n_shards,
                          engine, dtype):
    import time
    import jax
    from ..align.viterbi_sheared import batched_sheared_fill
    from ..align.backend import fill_impl, count_fill, KERNEL

    if fill_impl("linear", sharded=n_shards > 1) == KERNEL:
        _launch_kernel_linear_batch(jobs, idxs, results, Lp, Rp, engine)
        return

    t_launch = time.perf_counter()
    B = len(idxs)
    # pad the batch to a power of two (and a multiple of the mesh) so
    # jitted fills are reused across generations of shrinking width
    pad_to = 1
    while pad_to < B:
        pad_to *= 2
    pad_to = -(-pad_to // n_shards) * n_shards
    batch = [jobs[i] for i in idxs]
    args, inputs = _stack_sheared(batch, Lp, Rp, pad_to, dtype)
    if mesh is not None and n_shards > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = NamedSharding(mesh, P("jobs"))
        args = [jax.device_put(a, spec) for a in args]
    bp, final = batched_sheared_fill(*args)
    count_fill("scan", next(iter(args[0].devices())), B)
    EXEC_STATS["launches"] += 1
    EXEC_STATS["batched_jobs"] += B
    EXEC_STATS["batched_cells"] += sum(
        inp["L"] * inp["R"] for inp in inputs)
    log_out("batched launch: %d jobs (bucket %dx%d, %d shard%s)"
            % (B, Lp, Rp, n_shards, "s" if n_shards > 1 else ""), 3)
    from ..utils import fetch_np
    bp = fetch_np(bp)
    final = fetch_np(final)
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    for b, i in enumerate(idxs):
        results[i] = _finish_sheared(jobs[i], inputs[b], bp[b], final[b],
                                     engine)


def _launch_kernel_linear_batch(jobs, idxs, results, Lp, Rp, engine):
    """One Hopper-kernel launch for a bucket of linear-chain jobs (one
    thread block per job)."""
    import time
    from ..align.hopper import linear_job, linear_fill
    from ..align.backend import count_fill, KERNEL

    t_launch = time.perf_counter()
    packed = [linear_job(jobs[i].left, jobs[i].right, jobs[i].model,
                         _job_settings(jobs[i]), Lp, Rp, band=jobs[i].band)
              for i in idxs]
    bp, final = linear_fill(packed, Lp + Rp - 1, Lp)
    count_fill(KERNEL, n=len(idxs))
    EXEC_STATS["launches"] += 1
    EXEC_STATS["batched_jobs"] += len(idxs)
    EXEC_STATS["batched_cells"] += sum(p["L"] * p["R"] for p in packed)
    log_out("batched launch: %d jobs (bucket %dx%d, kernel)"
            % (len(idxs), Lp, Rp), 3)
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    for b, i in enumerate(idxs):
        results[i] = _finish_sheared(jobs[i], packed[b], bp[b], final[b],
                                     engine)


def _fanin_batch_paths(jobs, idxs, Lp, Rp, mesh, n_shards, dtype):
    """One batched ring-buffer Viterbi fill for a bucket of fan-in
    graph jobs. Returns [(path, end)] per idx; a None entry means the
    banded fill dead-ended and the caller must retry that job single
    (viterbi_alignment.cpp:298-317)."""
    import time
    import jax
    t_launch = time.perf_counter()
    from ..align.viterbi_fanin import (prepare_fanin, stack_fanin,
                                       get_fanin_fill, finish_fanin,
                                       fanin_overcap, _g_bucket,
                                       _k_bucket)
    from ..align.backend import fill_impl, count_fill, KERNEL

    B = len(idxs)
    pad_to = 1
    while pad_to < B:
        pad_to *= 2
    pad_to = -(-pad_to // n_shards) * n_shards

    inputs = []
    for i in idxs:
        job = jobs[i]
        s = _job_settings(job)
        inp = prepare_fanin(job.left, job.right, job.model, s,
                            dtype=dtype)
        if job.band is not None:
            L, R = inp["L"], inp["R"]
            inp["band_upper"] = np.clip(
                np.asarray(job.band[0][:L], np.int64), 0,
                R - 1).astype(np.int32)
            inp["band_lower"] = np.clip(
                np.asarray(job.band[1][:L], np.int64), 0,
                R - 1).astype(np.int32)
        inputs.append(inp)
    KL = _k_bucket(max(inp["KL"] for inp in inputs))
    KR = _k_bucket(max(inp["KR"] for inp in inputs))
    G = _g_bucket(max(inp["OL"] + inp["OR"] for inp in inputs))
    EXEC_STATS["fanin_batches"] += 1
    paths: list = [None] * B

    def finish(b, i, bp_b, snaps_b, ilo):
        job = jobs[i]
        s = _job_settings(job)
        paths[b] = finish_fanin(
            inputs[b], bp_b, snaps_b, ilo,
            job.left, job.right, job.model, s,
            job.left_branch_length, job.right_branch_length,
            kr_decode=KR)
        if paths[b][0] is None:
            paths[b] = None

    OLx = max(i["OL"] for i in inputs)
    ORx = max(i["OR"] for i in inputs)
    overcap = fanin_overcap(KL, KR, OLx, ORx)
    if fill_impl("fanin", sharded=n_shards > 1, overcap=overcap) == KERNEL:
        from ..align.hopper import fanin_fill
        bpB, snapsB = fanin_fill(inputs, Lp, Rp, KL, KR)
        count_fill(KERNEL, n=B)
        EXEC_STATS["launches"] += 1
        EXEC_STATS["batched_jobs"] += B
        EXEC_STATS["batched_cells"] += sum(
            inp["L"] * inp["R"] for inp in inputs)
        log_out("batched fan-in launch: %d jobs (bucket %dx%d K%d/%d, "
                "kernel)" % (B, Lp, Rp, KL, KR), 3)
        EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
        ilo = np.zeros(Lp + Rp - 1, np.int32)
        for b, i in enumerate(idxs):
            finish(b, i, bpB[b], tuple(snapsB[b]), ilo)
        return paths

    stacked = inputs + [inputs[0]] * (pad_to - B)
    args = stack_fanin(stacked, Lp, Rp, KL, KR, G, dtype=dtype)
    if mesh is not None and n_shards > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = NamedSharding(mesh, P("jobs"))
        # ilo_ext (arg 12) is the shared window schedule: replicate it
        args = [jax.device_put(a, spec) if k != 12 else a
                for k, a in enumerate(args)]
    # offsets are static kernel-key dims like K: bucket them so the
    # creep (one homopolymer run at a time) reuses compiled kernels
    fill = get_fanin_fill(KL, KR, G, Lp, OLm=_k_bucket(OLx),
                          ORm=_k_bucket(ORx))
    bp, sM, sX, sY = fill(*args)
    count_fill("scan", next(iter(args[0].devices())), B)
    EXEC_STATS["launches"] += 1
    EXEC_STATS["batched_jobs"] += B
    EXEC_STATS["batched_cells"] += sum(
        inp["L"] * inp["R"] for inp in inputs)
    log_out("batched fan-in launch: %d jobs (bucket %dx%d K%d/%d G%d, "
            "%d shard%s)" % (B, Lp, Rp, KL, KR, G, n_shards,
                             "s" if n_shards > 1 else ""), 3)
    from ..utils import fetch_np
    bp = fetch_np(bp)
    sM, sX, sY = fetch_np(sM), fetch_np(sX), fetch_np(sY)
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    D = Lp + Rp - 1
    ilo = np.zeros(D, np.int32)
    for b, i in enumerate(idxs):
        finish(b, i, bp[:, b, :], (sM[b], sX[b], sY[b]), ilo)
    return paths


def _launch_fanin_batch(jobs, idxs, results, Lp, Rp, mesh, n_shards,
                        engine, dtype):
    """Batched fan-in Viterbi fills + per-job ancestral builds."""
    from ..align.ancestral import build_ancestral_graph
    paths = _fanin_batch_paths(jobs, idxs, Lp, Rp, mesh, n_shards,
                               dtype)
    for b, i in enumerate(idxs):
        job = jobs[i]
        if paths[b] is None:
            # banded dead end: full-matrix retry via the single path
            job.band = None
            results[i] = _run_single(job, engine)
            continue
        path, end = paths[b]
        settings = _job_settings(job)
        anc = build_ancestral_graph(job.left, job.right, path, job.model,
                                    settings,
                                    job.left_branch_length,
                                    job.right_branch_length,
                                    job.is_reads_sequence,
                                    compute_consensus=job.compute_consensus)
        results[i] = (anc, end)


def _launch_fullprob_batch(jobs, idxs, results, Lp, Rp, mesh, n_shards,
                           engine, dtype):
    """One vmapped launch fills a bucket of full-probability /
    sampling jobs' scaled fwd/bwd planes (plus one batched Viterbi
    launch for the non-sampling jobs); posteriors, stochastic draws and
    ancestral builds finish per job on host in job order (the same RNG
    stream the sequential loop would consume)."""
    import time
    import jax
    import jax.numpy as jnp
    from dataclasses import replace as _replace
    import pagan2_tpu.align as al
    from ..align import fullprob as fp
    from ..align.ancestral import build_ancestral_graph
    from ..align.oracle import PathPtr
    from ..align.viterbi_sheared import (batched_sheared_fill,
                                         _ShearedCells,
                                         _end_corner_linear)
    from ..align.viterbi_jax import _backtrack_arrays
    from ..io import plots

    t_launch = time.perf_counter()
    B = len(idxs)
    pad_to = 1
    while pad_to < B:
        pad_to *= 2
    pad_to = -(-pad_to // n_shards) * n_shards

    sjobs = []
    for i in idxs:
        job = jobs[i]
        s = _job_settings(job)
        if (s.sample_path or s.sample_additional_paths > 0) and \
                not s.compute_full_score:
            # sampling draws from fwd probabilities
            # (basic_alignment.h:621-625)
            s = _replace(s, compute_full_score=True)
        sjobs.append(s)

    inputs = [fp.linear_fullprob_inputs(jobs[i].left, jobs[i].right,
                                        jobs[i].model, dtype,
                                        Lp=Lp, Rp=Rp)
              for i in idxs]
    pads = inputs + [inputs[0]] * (pad_to - B)

    def stk(k, dt=None):
        return jnp.asarray(np.stack([np.asarray(p[k], dt) if dt
                                     else p[k] for p in pads]))

    args = [stk("msp_sh"), stk("wr_rext"), stk("wl"), stk("consts"),
            jnp.asarray(np.array([p["L"] for p in pads], np.int32)),
            jnp.asarray(np.array([p["R"] for p in pads], np.int32))]
    seeds = jnp.asarray(np.array([p["seed"] for p in pads]))
    if mesh is not None and n_shards > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = NamedSharding(mesh, P("jobs"))
        args = [jax.device_put(a, spec) for a in args]
        seeds = jax.device_put(seeds, spec)
        fM, fX, fY, fcum = fp._fwd_fill_batched(*args)
        bM, bX, bY, bcum = fp._bwd_fill_batched(*args, seeds)
    else:
        (fM, fX, fY, fcum), (bM, bX, bY, bcum) = \
            fp.linear_plane_fills(*args, seeds)
    from ..align.backend import count_fill
    count_fill("fullprob", next(iter(args[0].devices())), B)

    # batched Viterbi fill for the jobs that follow the best path
    # (sampling jobs draw their path from the planes instead)
    vit = [b for b, i in enumerate(idxs) if not sjobs[b].sample_path]
    bp = final = None
    vinputs = None
    if vit:
        vjobs = [jobs[idxs[b]] for b in vit]
        # pad to a power of two (and a mesh multiple) like
        # _launch_sheared_batch, so shrinking generations reuse ONE
        # compiled fill instead of one per distinct job count
        vpad = 1
        while vpad < len(vit):
            vpad *= 2
        vpad = -(-vpad // n_shards) * n_shards
        vargs, vinputs = _stack_sheared(vjobs, Lp, Rp, vpad, dtype)
        if mesh is not None and n_shards > 1:
            from jax.sharding import NamedSharding, PartitionSpec as P
            spec = NamedSharding(mesh, P("jobs"))
            vargs = [jax.device_put(a, spec) for a in vargs]
        bp, final = batched_sheared_fill(*vargs)

    from ..utils import fetch_np
    fM, fX, fY, fcum = (fetch_np(fM), fetch_np(fX), fetch_np(fY),
                        fetch_np(fcum))
    bM, bX, bY, bcum = (fetch_np(bM), fetch_np(bX), fetch_np(bY),
                        fetch_np(bcum))
    if bp is not None:
        bp = fetch_np(bp)
        final = fetch_np(final)
    EXEC_STATS["launches"] += 1
    EXEC_STATS["batched_jobs"] += B
    EXEC_STATS["batched_cells"] += sum(
        inp["L"] * inp["R"] for inp in inputs)
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    log_out("batched full-prob launch: %d jobs (bucket %dx%d, "
            "%d shard%s)" % (B, Lp, Rp, n_shards,
                             "s" if n_shards > 1 else ""), 3)

    vslot = {b: k for k, b in enumerate(vit)}
    for b, i in enumerate(idxs):
        job = jobs[i]
        s = sjobs[b]
        planes = fp.FullProbPlanes.from_arrays(
            job.left, job.right, job.model, inputs[b],
            (fM[b], fX[b], fY[b]), fcum[b],
            (bM[b], bX[b], bY[b]), bcum[b])
        if plots.posterior_sink_active():
            plots.add_posterior_figure_planes(planes)
        rng = al._RNG or np.random.default_rng()
        if s.sample_path:
            path, end = fp.sample_path_planes(
                planes, s, rng, job.left_branch_length,
                job.right_branch_length)
        else:
            k = vslot[b]
            cells = _ShearedCells(bp[k], job.left, job.right)
            end = _end_corner_linear(final[k], job.left, job.right,
                                     job.model, inputs[b]["L"],
                                     inputs[b]["R"])
            end.bwd_score = 1.0
            end.full_score = 1.0
            path = _backtrack_arrays(cells, job.left, job.right,
                                     PathPtr(end, True),
                                     inputs[b]["L"], inputs[b]["R"],
                                     job.left_branch_length,
                                     job.right_branch_length)
            fp.annotate_path(path, planes, end)
        anc = build_ancestral_graph(
            job.left, job.right, path, job.model, s,
            job.left_branch_length, job.right_branch_length,
            job.is_reads_sequence,
            compute_consensus=job.compute_consensus)
        if s.sample_additional_paths > 0:
            from ..align.sampling import merge_sampled_graph
            for _ in range(s.sample_additional_paths):
                extra = fp.sample_path_planes(
                    planes, s, rng, job.left_branch_length,
                    job.right_branch_length)[0]
                sg = build_ancestral_graph(
                    job.left, job.right, extra, job.model, s,
                    job.left_branch_length, job.right_branch_length,
                    job.is_reads_sequence)
                merge_sampled_graph(anc, sg)
        results[i] = (anc, end)


def _launch_fanin_fullprob_batch(jobs, idxs, results, Lp, Rp, mesh,
                                 n_shards, engine, dtype):
    """One vmapped gather-core launch fills a bucket of FAN-IN
    full-probability / sampling jobs' scaled fwd/bwd planes (plus one
    batched fan-in Viterbi launch for the non-sampling jobs) — a
    --sample-path / --full-probability progressive run no longer
    serializes after generation 1 (task-parallel intent of
    node.cpp:227-269 applied to viterbi_alignment.cpp:329-371)."""
    import time
    import jax
    import jax.numpy as jnp
    from dataclasses import replace as _replace
    import pagan2_tpu.align as al
    from ..align import fullprob as fp
    from ..align.ancestral import build_ancestral_graph
    from ..io import plots

    t_launch = time.perf_counter()
    B = len(idxs)
    pad_to = 1
    while pad_to < B:
        pad_to *= 2
    pad_to = -(-pad_to // n_shards) * n_shards

    sjobs = []
    for i in idxs:
        job = jobs[i]
        s = _job_settings(job)
        if (s.sample_path or s.sample_additional_paths > 0) and \
                not s.compute_full_score:
            s = _replace(s, compute_full_score=True)
        sjobs.append(s)

    inputs = [fp.fanin_fullprob_inputs(jobs[i].left, jobs[i].right,
                                       jobs[i].model, dtype,
                                       Lp=Lp, Rp=Rp)
              for i in idxs]
    from ..align.viterbi_fanin import _k_bucket
    KL = _k_bucket(max(p["KL"] for p in inputs))
    KR = _k_bucket(max(p["KR"] for p in inputs))
    KFL = _k_bucket(max(p["KFL"] for p in inputs))
    KFR = _k_bucket(max(p["KFR"] for p in inputs))
    OLm = max(p["OLm"] for p in inputs)
    ORm = max(p["ORm"] for p in inputs)
    F = max(8, ORm)
    # bucket the ring depth like the Viterbi path so generations with
    # creeping bridge offsets reuse one compiled kernel (extra ring
    # planes are inert: offsets never reach them)
    from ..align.viterbi_fanin import _g_bucket
    G = _g_bucket(OLm + ORm)
    Gs = max(p["seed_block"].shape[0] for p in inputs)

    def padk(a, k, axis):
        if a.shape[axis] == k:
            return a
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, k - a.shape[axis])
        return np.pad(a, pad)

    pads = inputs + [inputs[0]] * (pad_to - B)

    def stack(fn):
        return jnp.asarray(np.stack([fn(p) for p in pads]))

    rexts = [(fp.fanin_rext(p["roffp"], p["rwp"], Lp, Rp, F),
              fp.fanin_rext(p["rfoff"], p["rfw"], Lp, Rp, F))
             for p in pads]
    msp_b = stack(lambda p: p["msp_sh"])
    consts_b = stack(lambda p: p["consts"])
    Ldp_b = jnp.asarray(np.array([p["L"] for p in pads], np.int32))
    Rdp_b = jnp.asarray(np.array([p["R"] for p in pads], np.int32))
    loffp_b = stack(lambda p: padk(p["loffp"], KL, 1))
    lwp_b = stack(lambda p: padk(p["lwp"], KL, 1))
    lfoff_b = stack(lambda p: padk(p["lfoff"], KFL, 1))
    lfw_b = stack(lambda p: padk(p["lfw"], KFL, 1))
    roff_b = jnp.asarray(np.stack([padk(r[0][0], KR, 0)
                                   for r in rexts]))
    rw_b = jnp.asarray(np.stack([padk(r[0][1], KR, 0) for r in rexts]))
    rfoff_b = jnp.asarray(np.stack([padk(r[1][0], KFR, 0)
                                    for r in rexts]))
    rfw_b = jnp.asarray(np.stack([padk(r[1][1], KFR, 0)
                                  for r in rexts]))
    seed_b = stack(lambda p: padk(p["seed_block"], Gs, 0))

    fargs = [msp_b, loffp_b, lwp_b, roff_b, rw_b, consts_b, Ldp_b,
             Rdp_b]
    bargs = [msp_b, lfoff_b, lfw_b, rfoff_b, rfw_b, consts_b, Ldp_b,
             Rdp_b, seed_b]
    if mesh is not None and n_shards > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = NamedSharding(mesh, P("jobs"))
        fargs = [jax.device_put(a, spec) for a in fargs]
        bargs = [jax.device_put(a, spec) for a in bargs]
    fwd, bwd = fp.fanin_gather_fills_batched(KL, KR, KFL, KFR, G)
    fM, fX, fY, fcum = fwd(*fargs)
    bM, bX, bY, bcum = bwd(*bargs)
    from ..align.backend import count_fill
    count_fill("fullprob", next(iter(fargs[0].devices())), B)

    from ..utils import fetch_np
    fM, fX, fY, fcum = (fetch_np(fM), fetch_np(fX), fetch_np(fY),
                        fetch_np(fcum))
    bM, bX, bY, bcum = (fetch_np(bM), fetch_np(bX), fetch_np(bY),
                        fetch_np(bcum))
    EXEC_STATS["launches"] += 1
    EXEC_STATS["fanin_fp_batches"] += 1
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    log_out("batched fan-in full-prob launch: %d jobs (bucket %dx%d "
            "K%d/%d G%d, %d shard%s)"
            % (B, Lp, Rp, KL, KR, G, n_shards,
               "s" if n_shards > 1 else ""), 3)

    # batched fan-in Viterbi fill for the jobs that follow the best
    # path (sampling jobs draw their path from the planes instead).
    # Each logical job counts once in batched_jobs/cells: Viterbi jobs
    # count inside _fanin_batch_paths, sampling-only jobs here.
    vit = [b for b, i in enumerate(idxs) if not sjobs[b].sample_path]
    EXEC_STATS["batched_jobs"] += B - len(vit)
    EXEC_STATS["batched_cells"] += sum(
        inputs[b]["L"] * inputs[b]["R"]
        for b in range(B) if b not in set(vit))
    vpaths = None
    if vit:
        vpaths = _fanin_batch_paths(jobs, [idxs[b] for b in vit], Lp,
                                    Rp, mesh, n_shards, dtype)
    vslot = {b: k for k, b in enumerate(vit)}

    for b, i in enumerate(idxs):
        job = jobs[i]
        s = sjobs[b]
        planes = fp.FullProbPlanes.from_arrays(
            job.left, job.right, job.model, inputs[b],
            (fM[b], fX[b], fY[b]), fcum[b],
            (bM[b], bX[b], bY[b]), bcum[b], fanin=True)
        if plots.posterior_sink_active():
            plots.add_posterior_figure_planes(planes)
        rng = al._RNG or np.random.default_rng()
        if s.sample_path:
            path, end = fp.sample_path_planes(
                planes, s, rng, job.left_branch_length,
                job.right_branch_length)
        else:
            pe = vpaths[vslot[b]]
            if pe is None:      # pragma: no cover - no bands here
                results[i] = _run_single(job, engine)
                continue
            path, end = pe
            fp.annotate_path(path, planes, end)
        anc = build_ancestral_graph(
            job.left, job.right, path, job.model, s,
            job.left_branch_length, job.right_branch_length,
            job.is_reads_sequence,
            compute_consensus=job.compute_consensus)
        if s.sample_additional_paths > 0:
            from ..align.sampling import merge_sampled_graph
            for _ in range(s.sample_additional_paths):
                extra = fp.sample_path_planes(
                    planes, s, rng, job.left_branch_length,
                    job.right_branch_length)[0]
                sg = build_ancestral_graph(
                    job.left, job.right, extra, job.model, s,
                    job.left_branch_length, job.right_branch_length,
                    job.is_reads_sequence)
                merge_sampled_graph(anc, sg)
        results[i] = (anc, end)
