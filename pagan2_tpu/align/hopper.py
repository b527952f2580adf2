"""Hopper Viterbi fills (hopper_fills.cu) called through XLA's foreign
function interface.

The CUDA library is built for sm_90a from the source beside this file
into ``<checkout>/build/`` the first time a fill needs it, or ahead of
time with ``python -m pagan2_tpu.align.hopper``.  A missing nvcc or a
failed build raises: a GPU fill never drops quietly to the scan cores.

This module packs a job's O(L + R) row and column vectors, calls the
kernel and returns backpointer planes in the scan cores' layouts, so
the scan cores' host views (_ShearedCells, _BandedCells, _FaninCells)
decode them unchanged.  The arithmetic is the scan cores'; the kernels
are checked against them on the card (chip_smoke.py phase (a)).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("hopper_fills.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# bytes of a block's shared memory for DP state; larger state lives in
# a global scratch buffer (L2-resident at these sizes)
SMEM_BUDGET = 200 * 1024
# window positions per block when a fixed-window job splits over blocks
T_MAX = 2048

_lib = None


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libpagan2_fills-{tag}.so"


def build() -> Path:
    """Compile the kernels unless this source's library exists."""
    so = library_path()
    if so.exists():
        return so
    import jax
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the GPU fills need the CUDA "
                           "toolkit to build " + _SRC.name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC.name} failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _register():
    global _lib
    if _lib is not None:
        return
    import jax
    lib = ctypes.CDLL(str(build()))
    jax.ffi.register_ffi_target(
        "pagan2_linear_fill", jax.ffi.pycapsule(lib.Pagan2LinearFill),
        platform="CUDA")
    jax.ffi.register_ffi_target(
        "pagan2_fanin_fill", jax.ffi.pycapsule(lib.Pagan2FaninFill),
        platform="CUDA")
    _lib = lib


def _call_linear(rowf, rowi, colf, coli, tab, fsc, isc, ilo, W, T, nblk,
                 smem_state):
    """(bp (B, D, W) uint8, fin (B, 3) f32) from the linear kernel."""
    import jax
    _register()
    B, D = ilo.shape
    S = T + 2
    multi = nblk > 1
    out = jax.ffi.ffi_call("pagan2_linear_fill", (
        jax.ShapeDtypeStruct((B, D, W), np.uint8),
        jax.ShapeDtypeStruct((B, 3), np.float32),
        jax.ShapeDtypeStruct((B, nblk, D if multi else 1, 3), np.float32),
        jax.ShapeDtypeStruct((B, nblk), np.int32),
        jax.ShapeDtypeStruct(
            (B, nblk, 9, S) if not smem_state else (1,), np.float32),
        jax.ShapeDtypeStruct((1,), np.int32),
    ))(rowf, rowi, colf, coli, tab, fsc, isc, ilo, T=np.int64(T),
       nblk=np.int64(nblk), smem_state=np.int64(smem_state))
    return out[0], out[1]


def _call_fanin(rowf, rowi, colf, coli, tab, fsc, isc, ilo, W, Gr, PAD,
                smem_state):
    """(bp (B, D, W) uint32, snap (B, 3, Gr, W) f32) from the fan-in
    kernel."""
    import jax
    _register()
    B, D = ilo.shape
    out = jax.ffi.ffi_call("pagan2_fanin_fill", (
        jax.ShapeDtypeStruct((B, D, W), np.uint32),
        jax.ShapeDtypeStruct((B, 3, Gr, W), np.float32),
        jax.ShapeDtypeStruct(
            (B, 3 * Gr * (PAD + W)) if not smem_state else (1,),
            np.float32),
    ))(rowf, rowi, colf, coli, tab, fsc, isc, ilo, Gr=np.int64(Gr),
       PAD=np.int64(PAD), smem_state=np.int64(smem_state))
    return out[0], out[1]


# ----------------------------------------------------------------------
def linear_tiling(W: int, moving: bool):
    """(T, nblk, smem_state): a moving window runs in one block; a
    fixed window wider than T_MAX splits over blocks of T_MAX."""
    if moving or W <= T_MAX:
        T, nblk = W, 1
    else:
        T, nblk = T_MAX, -(-W // T_MAX)
    return T, nblk, int(9 * (T + 2) * 4 <= SMEM_BUDGET)


def window_rows(w) -> int:
    """Window rows for a band whose diagonals hold w in-band rows: the
    widest, rounded up to a warp (32 threads)."""
    n = int(np.max(w)) if len(w) else 1
    return max(32, -(-n // 32) * 32)


def linear_job(left, right, model, settings, Lr: int, Rc: int,
               band=None):
    """One linear-chain job's kernel vectors, padded to Lr rows and Rc
    columns (band: optional per-row (upper, lower) column bounds)."""
    from .viterbi_sheared import prepare_sheared
    f = np.float32
    inp = prepare_sheared(left, right, model, settings, f, with_ms=False)
    L, R = inp["L"], inp["R"]
    rowf = np.zeros((3, Lr), f)
    rowf[0, :L] = inp["lw"]
    rowf[1, :L] = inp["gext_i"]
    rowf[2, 1:L] = inp["open_l"][:L - 1]
    nf = model.log_score.shape[0]
    # states index the table python-style, as in the scan core's
    # log_score[np.ix_(lstates, rstates)]
    rowi = np.zeros((3, Lr), np.int32)
    rowi[0, :L] = np.mod(np.asarray(left.states[:L], np.int64), nf)
    rowi[2, :L] = R - 1
    if band is not None:
        rowi[1, :L] = np.asarray(band[0][:L], np.int32)
        rowi[2, :L] = np.asarray(band[1][:L], np.int32)
    colf = np.zeros((3, Rc), f)
    colf[0, :R] = inp["rw"]
    colf[1, :R] = inp["gext_j"]
    colf[2, :R] = inp["open_r_shifted"]
    coli = np.zeros(Rc, np.int32)
    coli[:R] = np.mod(np.asarray(right.states[:R], np.int64), nf)
    return dict(rowf=rowf, rowi=rowi, colf=colf, coli=coli,
                tab=np.asarray(model.log_score, f).ravel(),
                fsc=np.array([inp["lng"], inp["lgo"]], f),
                isc=np.array([L, R], np.int32), L=L, R=R)


def linear_fill(jobs: list[dict], D: int, W: int, ilo=None):
    """Fill a batch of linear_job dicts over D diagonals and a window
    of W rows (ilo: one job's per-diagonal window start; default the
    fixed window at row 0).  Returns host (bp (B, D, W) uint8, fin
    (B, 3) f32) in the scan cores' layout: bp[b, d, p] holds the codes
    of row ilo[d] + p on diagonal d."""
    from ..utils import fetch_np
    bp, fin = linear_fill_device(jobs, D, W, ilo)
    return fetch_np(bp), fetch_np(fin)


def _window_starts(ilo, B: int, D: int, unit_steps: bool):
    """(B, D) int32 window starts (default all 0).  They never decrease,
    and with unit_steps advance by at most one row per diagonal."""
    if ilo is None:
        return np.zeros((B, D), np.int32)
    ilo = np.broadcast_to(np.asarray(ilo, np.int32), (B, D))
    step = np.diff(ilo, axis=1)
    if step.size and step.min() < 0:
        raise ValueError("window start must never decrease")
    if unit_steps and step.size and step.max() > 1:
        raise ValueError("window start must advance by 0 or 1 rows per "
                         "diagonal")
    return ilo


def linear_fill_device(jobs: list[dict], D: int, W: int, ilo=None):
    """linear_fill with its results left on the device."""
    B = len(jobs)
    moving = ilo is not None and bool(np.any(ilo))
    ilo = _window_starts(ilo, B, D, True)
    T, nblk, smem = linear_tiling(W, moving)

    def stk(k):
        return np.ascontiguousarray(np.stack([j[k] for j in jobs]))
    return _call_linear(stk("rowf"), stk("rowi"), stk("colf"),
                        stk("coli"), stk("tab"), stk("fsc"), stk("isc"),
                        np.ascontiguousarray(ilo), W, T, nblk, smem)


def fanin_job(inp: dict, Lr: int, Rc: int, KL: int, KR: int):
    """One fan-in job's kernel vectors from a prepare_fanin dict (band
    bounds from its band_upper / band_lower entries), edge slots padded
    to KL / KR and rows / columns to Lr / Rc."""
    f = np.float32
    L, R = inp["L"], inp["R"]
    kl = inp["loff"].shape[1]
    kr = inp["roff"].shape[1]
    rowf = np.zeros((1 + 2 * KL, Lr), f)
    rowf[0, :L] = inp["gext_i"]
    rowf[1:1 + kl, :L] = inp["llw"].T
    rowf[1 + KL:1 + KL + kl, :L] = inp["lopen"].T
    nf = inp["log_score"].shape[0]
    # the scan core indexes the table by left state python-style and
    # clips right states (stack_fanin, _build_core_onehot)
    rowi = np.zeros((3 + KL, Lr), np.int32)
    rowi[0, :L] = np.mod(np.asarray(inp["lstates"], np.int64), nf)
    rowi[1, :L] = inp.get("band_upper", np.zeros(L, np.int32))[:L]
    rowi[2, :L] = inp.get("band_lower", np.full(L, R - 1, np.int32))[:L]
    rowi[3:3 + kl, :L] = inp["loff"].T
    colf = np.zeros((1 + 2 * KR, Rc), f)
    colf[0, :R] = inp["gext_j"]
    colf[1:1 + kr, :R] = inp["rlw"].T
    colf[1 + KR:1 + KR + kr, :R] = inp["ropen"].T
    coli = np.zeros((1 + KR, Rc), np.int32)
    coli[0, :R] = np.clip(inp["rstates"], 0, nf - 1)
    coli[1:1 + kr, :R] = inp["roff"].T
    return dict(rowf=rowf, rowi=rowi, colf=colf, coli=coli,
                tab=np.asarray(inp["log_score"], f).ravel(),
                fsc=np.array([inp["lng"], inp["lgo"]], f),
                isc=np.array([L, R], np.int32))


def fanin_fill(inputs: list[dict], Lp: int, Rp: int, KL: int, KR: int,
               W: int | None = None, ilo=None):
    """Fill a batch of prepare_fanin dicts over the Lp + Rp - 1
    diagonals of an Lp x Rp plane, in a window of W rows per diagonal
    starting at row ilo[d] (default: the full plane, W = Lp, ilo = 0;
    band bounds are masks inside the window).  Returns host (bp (B, D,
    W) uint32 in the scan cores' packing, snaps (B, 3, Gr, W) ring at
    each job's corner diagonal: snaps[b, m, g] holds diagonal
    L + R - 2 - g), both indexed by window position."""
    from ..utils import fetch_np
    bp, snap = fanin_fill_device(inputs, Lp, Rp, KL, KR, W, ilo)
    return fetch_np(bp), fetch_np(snap)


def fanin_fill_device(inputs: list[dict], Lp: int, Rp: int, KL: int,
                      KR: int, W: int | None = None, ilo=None):
    """fanin_fill with its results left on the device."""
    W = W or Lp
    if W > Lp:
        raise ValueError(f"window of {W} rows exceeds the {Lp}-row plane")
    ilo = _window_starts(ilo, len(inputs), Lp + Rp - 1, False)
    jobs = [fanin_job(inp, Lp, Rp, KL, KR) for inp in inputs]
    PAD = max(inp["OL"] for inp in inputs)
    Gr = PAD + max(inp["OR"] for inp in inputs) + 1
    smem = int(3 * Gr * (PAD + W) * 4 <= SMEM_BUDGET)

    def stk(k):
        return np.ascontiguousarray(np.stack([j[k] for j in jobs]))
    return _call_fanin(stk("rowf"), stk("rowi"), stk("colf"),
                       stk("coli"), stk("tab"), stk("fsc"), stk("isc"),
                       np.ascontiguousarray(ilo), W, Gr, PAD, smem)


if __name__ == "__main__":
    print(build())
