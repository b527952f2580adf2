"""ctypes loader for the native runtime (pagan2_native.cpp).

The shared object is built on first use with g++ (-O3) next to the
source; every entry point has a pure-Python fallback in the package, so
a missing toolchain only costs speed, never correctness. Set
PAGAN2_NO_NATIVE=1 to force the Python paths (used by the parity
tests)."""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pagan2_native.cpp")
_SO = os.path.join(_HERE, "pagan2_native.so")

_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", _SO, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        print("pagan2 native build failed:\n" + proc.stderr,
              file=sys.stderr)
        return False
    return True


def get_lib():
    """The loaded native library, or None (Python fallbacks apply)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("PAGAN2_NO_NATIVE"):
        return None
    if not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    i64 = ctypes.c_int64
    p64 = ctypes.POINTER(ctypes.c_int64)
    pd = ctypes.POINTER(ctypes.c_double)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    lib.p2n_prefix_anchors.restype = i64
    lib.p2n_prefix_anchors.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_char_p, i64, i64, p64, p64, p64,
        i64]
    lib.p2n_kmer_anchors.restype = i64
    lib.p2n_kmer_anchors.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_char_p, i64, i64, i64, p64, p64,
        p64, i64]
    lib.p2n_maxmin_subsample.restype = None
    lib.p2n_maxmin_subsample.argtypes = [pd, i64, i64, i64, pu8]
    _lib = lib
    return _lib


def _run_anchors(fn, s1: str, s2: str, *params):
    b1 = s1.encode()
    b2 = s2.encode()
    cap = max(len(s1), len(s2), 16)
    p64 = ctypes.POINTER(ctypes.c_int64)
    while True:
        o1 = np.empty(cap, dtype=np.int64)
        o2 = np.empty(cap, dtype=np.int64)
        ol = np.empty(cap, dtype=np.int64)
        n = fn(b1, len(b1), b2, len(b2), *params,
               o1.ctypes.data_as(p64), o2.ctypes.data_as(p64),
               ol.ctypes.data_as(p64), cap)
        if n < 0:
            return None
        if n <= cap:
            return o1[:n], o2[:n], ol[:n]
        cap = int(n)


def prefix_anchors(s1: str, s2: str, min_length: int):
    """Native find_prefix_anchors; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    return _run_anchors(lib.p2n_prefix_anchors, s1, s2, min_length)


def kmer_anchors(s1: str, s2: str, k: int, min_run: int = 1):
    """Native find_kmer_anchors; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    return _run_anchors(lib.p2n_kmer_anchors, s1, s2, k, min_run)


def maxmin_subsample(dist: np.ndarray, keep_n: int, first: int):
    """Native greedy max-min taxon subsampling; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    dist = np.ascontiguousarray(dist, dtype=np.float64)
    n = dist.shape[0]
    keep = np.zeros(n, dtype=np.uint8)
    lib.p2n_maxmin_subsample(
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, keep_n, first,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)
