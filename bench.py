"""Workload generators, kernel parity checks and a fill-rate benchmark.

The generators build the inputs PAGAN2 users run (a progressive DNA
family, 454 amplicon reads, query reads, related long pairs); the
parity checks compare each Hopper fill (pagan2_tpu/align/hopper.py)
with its plain-JAX scan core on the same device.  chip_smoke.py drives
both through the CLI on the card.

`python bench.py` prints one JSON line of DP fill rates (GCUPS) for
the linear, fan-in and anchored fills on the GPU, each through the fill
the backend policy picks; it refuses to run without a GPU.  The
CPU-scaled end-to-end cells (bench_pileup_e2e, bench_family_e2e,
bench_megabase with full=False) stay callable from the tests.
"""
import json
import sys
import time

import numpy as np

ACGT = list("ACGT")


def _mut(rng, base, p=0.1):
    mut = base.copy()
    idx = rng.random(len(base)) < p
    mut[idx] = rng.choice(ACGT, size=int(idx.sum()))
    return "".join(mut)


def balanced_newick(names, length=0.1, inner=0.05):
    def build(lo, hi):
        if hi - lo == 1:
            return f"{names[lo]}:{length}"
        mid = (lo + hi) // 2
        return f"({build(lo, mid)},{build(mid, hi)}):{inner}"
    return build(0, len(names)) + ";"


def family_entries(n, L, seed=5):
    """n related DNA sequences of ~L bp (10% substitutions, every third
    one with a 12 bp deletion) and their balanced guide tree."""
    from pagan2_tpu.io.fasta import FastaEntry
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, size=L)
    entries = []
    for i in range(n):
        s = _mut(rng, base)
        if i % 3 == 1:
            s = s[:L // 3] + s[L // 3 + 12:]
        entries.append(FastaEntry(name=f"s{i}", sequence=s))
    return entries, balanced_newick([e.name for e in entries])


def pileup_reads(n_reads, rlen, glen, seed=3):
    """Amplicon-style 454 reads (one locus, deep coverage) of a
    homopolymer-rich genome, with 1% homopolymer over- and 1%
    under-calls — the reference's 454 demo shape: the accept gate
    scores overlap against the first read (reads_aligner.cpp:3323-3466),
    so every read overlaps it."""
    from pagan2_tpu.io.fasta import FastaEntry
    rng = np.random.default_rng(seed)
    parts = []
    total = 0
    while total < glen:
        c = ACGT[int(rng.integers(0, 4))]
        run = int(rng.integers(1, 5))
        parts.append(c * run)
        total += run
    genome = "".join(parts)
    reads = []
    for k in range(n_reads):
        start = int(rng.integers(0, max(len(genome) - rlen, 1)))
        r = []
        for c in genome[start:start + rlen]:
            u = rng.random()
            if u < 0.01:
                r.append(c + c)        # homopolymer overcall
            elif u < 0.02:
                pass                   # undercall
            else:
                r.append(c)
        reads.append(FastaEntry(f"r{k:03d}", "".join(r)))
    return reads


def query_reads(entries, n, rlen, seed=7):
    """n reads of rlen bp cut from the family's sequences."""
    from pagan2_tpu.io.fasta import FastaEntry
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        s = entries[k % len(entries)].sequence
        st = int(rng.integers(0, max(len(s) - rlen, 1)))
        out.append(FastaEntry(f"q{k}", s[st:st + rlen]))
    return out


def related_pair(N, p, seed=0):
    """Two DNA sequences of N bp, the second with substitutions at
    rate p."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, size=N)
    return "".join(base), _mut(rng, base, p)


def _dna_model():
    from pagan2_tpu.models import ModelFactory, alphabets as alph
    return ModelFactory(alph.DNA).alignment_model(0.2)


def capped_runs(rng, N, max_run=4):
    """N bp of DNA whose homopolymer runs are at most max_run long, so
    454 read graphs stay within the fan-in kernel's graph-shape caps."""
    out = []
    while len(out) < N:
        c = ACGT[int(rng.integers(0, 4))]
        if out and out[-1] == c:
            continue
        out.extend(c * int(rng.integers(1, max_run + 1)))
    return np.array(out[:N])


def _wall(fn, reps=3):
    """Best wall seconds of fn() (which must block) after one warmup."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


# ----------------------------------------------------------------------
# kernel parity: the Hopper fill against its scan core on the device.
# Times are device fills from host inputs to results on the device
# (block_until_ready), without the readback both paths share.
def parity_linear(B=16, N=2047, seed=0):
    """B related N-bp pairs through the linear kernel and
    batched_sheared_fill: backpointer planes and corner scores must be
    identical."""
    import jax
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import alphabets as alph
    from pagan2_tpu.align import AlignSettings, hopper
    from pagan2_tpu.align.viterbi_sheared import (
        prepare_sheared, shear_device_inputs, batched_sheared_fill, _bucket)
    model, settings = _dna_model(), AlignSettings()
    pairs = [related_pair(N, 0.1, seed + b) for b in range(B)]
    graphs = [(build_leaf_graph(a, alph.DNA), build_leaf_graph(c, alph.DNA))
              for a, c in pairs]
    Lp = Rp = _bucket(N)
    jobs = [hopper.linear_job(g1, g2, model, settings, Lp, Rp)
            for g1, g2 in graphs]
    per = [shear_device_inputs(prepare_sheared(g1, g2, model, settings,
                                               np.float32), Lp=Lp, Rp=Rp)
           for g1, g2 in graphs]
    args = [jax.device_put(np.stack([p[k] for p in per]))
            for k in range(len(per[0]))]

    def kern():
        return jax.block_until_ready(
            hopper.linear_fill_device(jobs, Lp + Rp - 1, Lp))

    def scan():
        return jax.block_until_ready(batched_sheared_fill(*args))
    bp_k, fin_k = (np.asarray(x) for x in kern())
    bp_s, fin_s = (np.asarray(a) for a in scan())
    return dict(
        fill="linear", case=f"{B}x{N}bp",
        bp_identical=bool(np.array_equal(bp_k, bp_s.view(np.uint8))),
        score_max_rel=_max_rel(fin_k, fin_s),
        kernel_s=_wall(kern), scan_s=_wall(scan),
        readback=_readback(kern),
        cells=sum((len(a)) * len(c) for a, c in pairs))


def _readback(fill, reps=3):
    """(best seconds, bytes) of fetch_np on the backpointer plane of a
    fresh fill(): the device-to-host copy every fill pays before its
    backtrack (a jax.Array caches its host copy, hence a fresh one)."""
    from pagan2_tpu.utils import fetch_np
    best = float("inf")
    for _ in range(reps):
        bp = fill()[0]
        t0 = time.perf_counter()
        fetch_np(bp)
        best = min(best, time.perf_counter() - t0)
    return best, int(bp.nbytes)


def parity_band(N=131071, p=0.03, seed=1):
    """One anchored N-bp pair through the windowed kernel and the
    banded scan core (banded_fill_args)."""
    import jax
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import alphabets as alph
    from pagan2_tpu.align import AlignSettings, hopper, plan_band
    from pagan2_tpu.align.viterbi_banded import (band_schedule,
                                                 banded_fill_args)
    model, settings = _dna_model(), AlignSettings()
    a, c = related_pair(N, p, seed)
    g1, g2 = build_leaf_graph(a, alph.DNA), build_leaf_graph(c, alph.DNA)
    (upper, lower), _ = plan_band(g1, g2, settings)
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    ilo, w = band_schedule(upper, lower, L, R)
    W = hopper.window_rows(w)
    job = hopper.linear_job(g1, g2, model, settings, L, R,
                            band=(upper, lower))

    def kern():
        return jax.block_until_ready(
            hopper.linear_fill_device([job], L + R - 1, W, ilo=ilo))
    core, args, _ilo, _inp = banded_fill_args(g1, g2, model, settings,
                                              upper, lower, np.float32)

    def scan():
        return jax.block_until_ready(core(*args))
    bp_k, fin_k = (np.asarray(x) for x in kern())
    bp_s, fin_s = (np.asarray(x) for x in scan())
    bp_s = bp_s.view(np.uint8)[:L + R - 1]
    Wc = min(W, bp_s.shape[1])
    same = (np.array_equal(bp_k[0, :, :Wc], bp_s[:, :Wc])
            and not np.any(bp_k[0, :, Wc:] != 0x3F)
            and not np.any(bp_s[:, Wc:] != 0x3F))
    in_band = int(np.sum(w))
    return dict(fill="band", case=f"{N}bp pair, window {W}",
                bp_identical=bool(same),
                score_max_rel=_max_rel(fin_k[0], fin_s),
                kernel_s=_wall(kern, 2), scan_s=_wall(scan, 2),
                cells=in_band)


def fanin_inputs(B, N, seed=2):
    """B pairs of 454 read graphs of N bp (homopolymer skip edges)."""
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import alphabets as alph
    from pagan2_tpu.align import AlignSettings
    from pagan2_tpu.align.viterbi_fanin import prepare_fanin
    rng = np.random.default_rng(seed)
    model, settings = _dna_model(), AlignSettings()
    inputs = []
    for _ in range(B):
        base = rng.choice(ACGT, size=N)
        # homopolymer runs so 454 mode adds skip edges
        base[N // 3:N // 3 + 6] = "A"
        base[2 * N // 3:2 * N // 3 + 5] = "T"
        g1 = build_leaf_graph("".join(base), alph.DNA, mode454=True)
        g2 = build_leaf_graph(_mut(rng, base), alph.DNA, mode454=True)
        inputs.append(prepare_fanin(g1, g2, model, settings,
                                    dtype=np.float32))
    return inputs


def parity_fanin(B=16, N=2047, seed=2):
    """B 454 read-graph pairs through the fan-in kernel and the one-hot
    scan core (get_fanin_fill)."""
    import jax
    from pagan2_tpu.align import hopper
    from pagan2_tpu.align.viterbi_fanin import (
        stack_fanin, get_fanin_fill, _bucket, _g_bucket, _k_bucket)
    inputs = fanin_inputs(B, N, seed)
    KL = _k_bucket(max(i["KL"] for i in inputs))
    KR = _k_bucket(max(i["KR"] for i in inputs))
    OL = max(i["OL"] for i in inputs)
    OR = max(i["OR"] for i in inputs)
    G = _g_bucket(OL + OR)
    Lp = _bucket(max(i["L"] for i in inputs))
    Rp = _bucket(max(i["R"] for i in inputs))
    args = [jax.device_put(np.asarray(a))
            for a in stack_fanin(inputs, Lp, Rp, KL, KR, G,
                                 dtype=np.float32)]
    fill = get_fanin_fill(KL, KR, G, Lp, OLm=_k_bucket(OL),
                          ORm=_k_bucket(OR))

    def kern():
        return jax.block_until_ready(
            hopper.fanin_fill_device(inputs, Lp, Rp, KL, KR))

    def scan():
        return jax.block_until_ready(fill(*args))
    bp_k, snap_k = (np.asarray(x) for x in kern())
    bp_s, sM, sX, sY = (np.asarray(x) for x in scan())
    snap_s = np.stack([sM, sX, sY], axis=1)        # (B, 3, G, W)
    g = min(snap_k.shape[2], snap_s.shape[2])
    return dict(
        fill="fanin", case=f"{B}x{N}bp 454 K{KL}/{KR}",
        bp_identical=bool(np.array_equal(bp_k, np.swapaxes(bp_s, 0, 1))),
        score_max_rel=_max_rel(snap_k[:, :, :g], snap_s[:, :, :g]),
        kernel_s=_wall(kern), scan_s=_wall(scan),
        cells=sum(i["L"] * i["R"] for i in inputs))


def parity_fanin_band(N=32767, p=0.03, seed=3):
    """One anchored pair of N-bp 454 read graphs (homopolymer skip
    edges, a 12 bp deletion) through the fan-in kernel and the one-hot
    scan core, both in the band's window; then the whole single-pair
    path (fanin_align_path) on the fill the policy picks."""
    import jax
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import alphabets as alph
    from pagan2_tpu.align import AlignSettings, hopper, plan_band
    from pagan2_tpu.align.viterbi_fanin import (
        prepare_fanin, stack_fanin, get_fanin_fill, fanin_align_path,
        fanin_overcap, band_window, _bucket, _g_bucket, _k_bucket)
    model, settings = _dna_model(), AlignSettings()
    rng = np.random.default_rng(seed)
    base = capped_runs(rng, N)
    s1 = "".join(base)
    s2 = _mut(rng, base, p)
    s2 = s2[:N // 3] + s2[N // 3 + 12:]

    def graphs():
        return (build_leaf_graph(s1, alph.DNA, mode454=True),
                build_leaf_graph(s2, alph.DNA, mode454=True))
    g1, g2 = graphs()
    (upper, lower), _ = plan_band(g1, g2, settings)
    inp = prepare_fanin(g1, g2, model, settings, dtype=np.float32)
    L, R = inp["L"], inp["R"]
    KL, KR = _k_bucket(inp["KL"]), _k_bucket(inp["KR"])
    if fanin_overcap(KL, KR, inp["OL"], inp["OR"]):
        raise ValueError("fan-in pair beyond the kernel's caps")
    Lp, Rp = _bucket(L), _bucket(R)
    W, ilo = band_window(inp, (upper, lower), Lp, Rp)
    G = _g_bucket(inp["OL"] + inp["OR"])
    args = [jax.device_put(np.asarray(a))
            for a in stack_fanin([inp], Lp, Rp, KL, KR, G, W=W, ilo=ilo,
                                 dtype=np.float32)]
    fill = get_fanin_fill(KL, KR, G, W, OLm=_k_bucket(inp["OL"]),
                          ORm=_k_bucket(inp["OR"]))

    def kern():
        return jax.block_until_ready(hopper.fanin_fill_device(
            [inp], Lp, Rp, KL, KR, W=W, ilo=ilo))

    def scan():
        return jax.block_until_ready(fill(*args))
    bp_k, snap_k = (np.asarray(x) for x in kern())
    bp_s, sM, sX, sY = (np.asarray(x) for x in scan())
    snap_s = np.stack([sM, sX, sY], axis=1)
    g = min(snap_k.shape[2], snap_s.shape[2])
    ga, gb = graphs()
    path, end = fanin_align_path(ga, gb, model, settings,
                                 band=(upper, lower), dtype=np.float32)
    return dict(
        fill="fanin band",
        case=f"{N}bp 454 pair K{KL}/{KR}, window {W} of {Lp} rows",
        bp_identical=bool(np.array_equal(bp_k, np.swapaxes(bp_s, 0, 1))),
        score_max_rel=_max_rel(snap_k[:, :, :g], snap_s[:, :, :g]),
        kernel_s=_wall(kern, 1), scan_s=_wall(scan, 1),
        path_score=float(end.score), path_len=len(path),
        cells=int(np.sum(np.clip(lower[:L] - upper[:L] + 1, 0, None))))


def _max_rel(a, b):
    """Largest relative difference over finite entries; inf where the
    finite masks differ."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb) or not np.array_equal(a[~fa], b[~fb]):
        return float("inf")
    if not fa.any():
        return 0.0
    d = np.abs(a[fa] - b[fa]) / np.maximum(np.abs(b[fa]), 1e-30)
    return float(d.max())


# ----------------------------------------------------------------------
# end-to-end cells (wall seconds in this process, compile included)
def bench_pileup_e2e(full=True):
    """Reference-free 454 pileup with homopolymer edges and consensus:
    40 x 384 bp reads (6 x 96 bp CPU-scaled)."""
    from pagan2_tpu.models import alphabets as alph
    from pagan2_tpu.pipeline.pileup import pileup_align, PileupConfig
    from pagan2_tpu.parallel import executor
    n_reads, rlen, glen = (40, 384, 420) if full else (6, 96, 110)
    reads = pileup_reads(n_reads, rlen, glen)
    executor.reset_stats()
    kk0 = executor.kernel_key_counts()
    t0 = time.perf_counter()
    res = pileup_align(reads, alph.DNA,
                       PileupConfig(homopolymer=True, use_consensus=True))
    dt = time.perf_counter() - t0
    placed = n_reads - len(res.discarded)
    scan_k = executor.kernel_key_counts()["fanin_scan"] - kk0["fanin_scan"]
    return dt, (f"{n_reads}x{rlen}bp 454-style reads, {placed} placed, "
                f"consensus {len(res.consensus or '')}bp, "
                f"{scan_k} fan-in scan-core keys")


def bench_family_e2e(full=True):
    """Tree-guided progressive family: 16 x 1535 bp (6 x 160 bp
    CPU-scaled)."""
    from pagan2_tpu.models import alphabets as alph
    from pagan2_tpu.pipeline.progressive import align_progressive
    n, L = (16, 1535) if full else (6, 160)
    entries, newick = family_entries(n, L)
    t0 = time.perf_counter()
    res = align_progressive(entries, newick, data_type=alph.DNA)
    dt = time.perf_counter() - t0
    return dt, (f"{n}x{L}bp progressive family, "
                f"{len(res.alignment[0].sequence)} cols")


def bench_megabase(rng, model, settings, full=True):
    """1 Mb pair at 1% divergence (32 kb CPU-scaled) through anchoring
    and the band fill the policy picks: fill milliseconds, with the
    host-prep breakdown (graph build, anchor scan, band smoothing)."""
    from dataclasses import replace
    from pagan2_tpu.graph import build_leaf_graph
    from pagan2_tpu.models import alphabets as alph
    from pagan2_tpu.align import plan_band, anchors as anch
    from pagan2_tpu.align.viterbi_banded import banded_align_path
    N = 1048575 if full else 32767
    base = rng.choice(ACGT, size=N)
    mut = _mut(rng, base, 0.01)
    t0 = time.perf_counter()
    g1 = build_leaf_graph("".join(base), alph.DNA)
    g2 = build_leaf_graph(mut, alph.DNA)
    t_build = time.perf_counter()
    band, _skipped = plan_band(g1, g2, replace(settings, force_gap=True))
    upper, lower = band
    t_band = time.perf_counter()
    in_band = int(np.sum(np.clip(np.asarray(lower[:N], np.int64)
                                 - np.asarray(upper[:N], np.int64) + 1,
                                 0, None)))
    prep = {"build_s": t_build - t0,
            "anchor_scan_s": anch.PREP_TIMINGS.get("anchor_scan_s", 0.0),
            "band_smooth_s": anch.PREP_TIMINGS.get("band_smooth_s", 0.0),
            "total_s": t_band - t0}

    def fill():
        return banded_align_path(g1, g2, model, settings, upper, lower,
                                 dtype=np.float32)
    dt = _wall(fill, 1)
    return dt * 1e3, (f"{N}bp pair, {in_band / dt / 1e9:.3g} in-band "
                      f"GCUPS incl. backtrack, host prep "
                      f"{prep['total_s']:.1f}s"), prep


def require_gpu():
    """Exit unless JAX's first device is an NVIDIA GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs an NVIDIA GPU; JAX found {dev.platform!r}")
    return dev


def main():
    dev = require_gpu()
    from pagan2_tpu.cli import configure_compile_cache
    configure_compile_cache()
    rates = {}
    for fn in (parity_linear, parity_fanin, parity_band,
               parity_fanin_band):
        r = fn()
        rates[r["fill"]] = {"gcups": r["cells"] / r["kernel_s"] / 1e9,
                            "case": r["case"],
                            "bp_identical": r["bp_identical"]}
    print(json.dumps({"metric": "DP fill rate, Hopper kernels",
                      "unit": "GCUPS", "device": dev.device_kind,
                      "fills": rates}))


if __name__ == "__main__":
    sys.exit(main())
