"""Smoke run of the alignment main path on one NVIDIA GPU.

    python chip_smoke.py               # phases (a)-(f) on one card
    python chip_smoke.py --four-cards  # the 4-card mesh runs only

Phase (a) compares each Hopper fill with its plain-JAX scan core on the
card; phases (b)-(f) drive the CLI (pagan2_tpu.cli.main) in this
process at the sizes PAGAN2 users run: (b) a 16 x 1535 bp progressive
family, (c) a 40 x 384 bp 454 amplicon pileup, (d) 8 query reads placed
onto (b)'s alignment, (e) an anchored 131,071 bp pair, (f) an 8 x 500
bp family with --full-probability.  (b), (d) and (e) run again on the
CPU device of this process and must write byte-identical files.  Each
phase prints its wall time and its fills per implementation and
device.  Any failure raises; the last line is one JSON object.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


def _write_fasta(path, entries):
    with open(path, "w") as f:
        for e in entries:
            f.write(f">{e.name}\n{e.sequence}\n")


def _fills():
    from pagan2_tpu.align.backend import FILL_COUNTS
    from pagan2_tpu.parallel.executor import EXEC_STATS, kernel_key_counts
    return dict(fills=dict(FILL_COUNTS), launches=EXEC_STATS["launches"],
                batched_jobs=EXEC_STATS["batched_jobs"],
                **kernel_key_counts())


def _run_cli(tag, argv, device=None, gpu_fills=True):
    """cli.main(argv) on `device` (default: the GPU); prints the wall
    and fill counts; returns (wall seconds, fill summary).  A GPU run
    with gpu_fills must have filled on the card."""
    import jax
    from pagan2_tpu import cli
    from pagan2_tpu.parallel import executor
    executor.reset_stats()
    t0 = time.perf_counter()
    if device is None:
        rc = cli.main(argv + ["--silent"])
    else:
        with jax.default_device(device):
            rc = cli.main(argv + ["--silent"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{tag}: cli.main returned {rc}")
    fills = _fills()
    print(f"phase {tag}: wall {wall:.3f} s, {json.dumps(fills)}",
          flush=True)
    if device is None and gpu_fills and not any(
            k.endswith("@gpu") for k in fills["fills"]):
        raise RuntimeError(f"{tag}: no fill ran on the GPU")
    return wall, fills


def _same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise RuntimeError(f"{a} and {b} differ")


def _names(path):
    with open(path) as f:
        return [ln[1:].strip() for ln in f if ln.startswith(">")]


def phase_a():
    import bench
    for fn in (bench.parity_linear, bench.parity_band, bench.parity_fanin,
               bench.parity_fanin_band):
        r = fn()
        print(f"phase a {r['fill']}: {r['case']}, kernel "
              f"{r['kernel_s']:.4f} s, scan core {r['scan_s']:.4f} s, "
              f"bp identical {r['bp_identical']}, max rel score diff "
              f"{r['score_max_rel']:.3g}", flush=True)
        if not r["bp_identical"] or r["score_max_rel"] > 1e-6:
            raise RuntimeError(f"phase a {r['fill']}: kernel != scan core")
        if "readback" in r:
            sec, nbytes = r["readback"]
            print(f"phase a {r['fill']} readback: {nbytes} bytes in "
                  f"{sec:.4f} s ({nbytes / sec / 1e9:.2f} GB/s)",
                  flush=True)
        if "path_len" in r:
            if not np.isfinite(r["path_score"]):
                raise RuntimeError("phase a fanin band: no path")
            print(f"phase a {r['fill']} path: {r['path_len']} steps, "
                  f"score {r['path_score']:.6f}", flush=True)


def phases_b_to_f(work, cpu):
    import bench
    w = lambda name: os.path.join(work, name)  # noqa: E731

    # (b) progressive family
    entries, newick = bench.family_entries(16, 1535)
    _write_fasta(w("fam.fas"), entries)
    with open(w("fam.nh"), "w") as f:
        f.write(newick + "\n")
    fam = ["-s", w("fam.fas"), "-t", w("fam.nh")]
    _run_cli("b", fam + ["-o", w("b_gpu")])
    _run_cli("b cpu", fam + ["-o", w("b_cpu")], cpu)
    _same_files(w("b_gpu.fas"), w("b_cpu.fas"))

    # (c) 454 amplicon pileup: its root's fan-in outgrows the kernel's
    # caps, so its fills are over-cap scans on the card
    reads = bench.pileup_reads(40, 384, 420)
    _write_fasta(w("reads.fas"), reads)
    _run_cli("c", ["--pileup", "--homopolymer", "--use-consensus",
                   "-q", w("reads.fas"), "-o", w("c")])
    placed = [n for n in _names(w("c.fas")) if re.fullmatch(r"r\d{3}", n)]
    if len(placed) != len(reads):
        raise RuntimeError(f"pileup placed {len(placed)} of "
                           f"{len(reads)} reads")

    # (d) query placement onto (b)'s alignment and tree
    _write_fasta(w("queries.fas"), bench.query_reads(entries, 8, 300))
    place = ["--ref-seqfile", w("b_gpu.fas"), "--ref-treefile",
             w("fam.nh"), "-q", w("queries.fas")]
    _run_cli("d", place + ["-o", w("d_gpu")])
    _run_cli("d cpu", place + ["-o", w("d_cpu")], cpu)
    _same_files(w("d_gpu.fas"), w("d_cpu.fas"))

    # (e) anchored long pair (anchoring fires above 3000 sites)
    a, b = bench.related_pair(131071, 0.03, seed=11)
    with open(w("pair.fas"), "w") as f:
        f.write(f">a\n{a}\n>b\n{b}\n")
    with open(w("pair.nh"), "w") as f:
        f.write("(a:0.05,b:0.05);\n")
    pair = ["-s", w("pair.fas"), "-t", w("pair.nh")]
    _run_cli("e", pair + ["-o", w("e_gpu")])
    _run_cli("e cpu", pair + ["-o", w("e_cpu")], cpu)
    _same_files(w("e_gpu.fas"), w("e_cpu.fas"))

    # (f) full probability
    fp_entries, fp_newick = bench.family_entries(8, 500, seed=13)
    _write_fasta(w("fp.fas"), fp_entries)
    with open(w("fp.nh"), "w") as f:
        f.write(fp_newick + "\n")
    _run_cli("f", ["-s", w("fp.fas"), "-t", w("fp.nh"),
                   "--full-probability", "-o", w("f_gpu")])


def four_cards(work):
    """The jobs-mesh family and the band-sharded 65,536-site pair on
    four cards, each against the same run on one card."""
    import bench
    from pagan2_tpu.parallel.executor import SHARDBAND_MIN_L
    w = lambda name: os.path.join(work, name)  # noqa: E731
    entries, newick = bench.family_entries(16, 1535)
    _write_fasta(w("fam.fas"), entries)
    with open(w("fam.nh"), "w") as f:
        f.write(newick + "\n")
    fam = ["-s", w("fam.fas"), "-t", w("fam.nh")]
    _run_cli("b 4 cards", fam + ["--devices", "4", "-o", w("b4")])
    _run_cli("b 1 card", fam + ["-o", w("b1")])
    _same_files(w("b4.fas"), w("b1.fas"))

    a, b = bench.related_pair(SHARDBAND_MIN_L, 0.03, seed=17)
    with open(w("big.fas"), "w") as f:
        f.write(f">a\n{a}\n>b\n{b}\n")
    with open(w("big.nh"), "w") as f:
        f.write("(a:0.05,b:0.05);\n")
    big = ["-s", w("big.fas"), "-t", w("big.nh"), "--no-anchors"]
    _, fills = _run_cli("shardband 4 cards",
                        big + ["--devices", "4", "-o", w("s4")])
    from pagan2_tpu.parallel.executor import EXEC_STATS
    if EXEC_STATS["shardband_fills"] != 1:
        raise RuntimeError("the 65,536-site pair was not band-sharded")
    _run_cli("shardband 1 card", big + ["-o", w("s1")])
    _same_files(w("s4.fas"), w("s1.fas"))


def main(argv):
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    print(_card(), flush=True)
    print(f"jax {jax.__version__}, {dev.device_kind}, "
          f"{len(jax.devices())} device(s)", flush=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pagan2_tpu.align import hopper
    hopper.build()
    with tempfile.TemporaryDirectory() as work:
        if "--four-cards" in argv:
            if len(jax.devices()) < 4:
                raise RuntimeError("--four-cards needs four GPUs")
            four_cards(work)
        else:
            phase_a()
            phases_b_to_f(work, jax.devices("cpu")[0])
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
