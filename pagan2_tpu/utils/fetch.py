"""Device->host array fetch with zero-copy fast path.

On the CPU backend np.from_dlpack aliases the device buffer directly
(saving a full copy of the backpointer planes — the largest readback on
every batched launch); on the GPU or when dlpack refuses, fall back to the
plain copying np.asarray. Under multi-host execution a globally-sharded
result is not fully addressable locally, so it is allgathered first
(every host finishes the whole generation's backtracks, mirroring the
replicated host-side prep). Results are read-only views; callers only
index them."""
import numpy as np


def fetch_np(x) -> np.ndarray:
    try:
        import jax
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            from ..parallel.multihost import gather_to_host
            return gather_to_host(x)
    except ImportError:      # pragma: no cover
        pass
    try:
        return np.from_dlpack(x)
    except Exception:
        return np.asarray(x)
