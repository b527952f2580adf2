"""Which implementation fills a pairwise Viterbi DP, decided in one place.

A fill runs on the device JAX places its arrays on: the default device
(``jax.default_device``) or, when none is set, the first device.  The
policy maps that device's platform and the kind of DP to exactly one
implementation:

=========  ===========================
platform   linear / band / fan-in
=========  ===========================
cpu        plain-JAX scan cores
gpu        Hopper kernels (hopper.py)
other      raises
=========  ===========================

A launch sharded over a device mesh is one jitted program, so it runs
the scan cores on every platform.  Fan-in graphs beyond the kernel's
caps (``overcap``) take the gather scan core.  Eligibility is decided
by the callers before the call; a kernel that fails raises.
"""
from __future__ import annotations

from collections import Counter

import jax

SCAN = "scan"
KERNEL = "kernel"

# fill kind -> implementation, per platform of the fill device
_FILLS = {
    "cpu": {"linear": SCAN, "band": SCAN, "fanin": SCAN},
    "gpu": {"linear": KERNEL, "band": KERNEL, "fanin": KERNEL},
}


# fills run this process, keyed "<implementation>@<platform>"
FILL_COUNTS: Counter = Counter()


def count_fill(impl: str, device=None, n: int = 1) -> None:
    """Count n pairwise fills run by `impl` on `device` (default: the
    fill device)."""
    FILL_COUNTS[f"{impl}@{(device or fill_device()).platform}"] += n


def fill_device():
    """The device an unsharded fill runs on."""
    d = jax.config.jax_default_device
    if d is None:
        return jax.devices()[0]
    if isinstance(d, str):
        return jax.devices(d)[0]
    return d


def _platform(device) -> str:
    plat = (device or fill_device()).platform
    if plat not in _FILLS:
        raise RuntimeError(
            f"no pairwise DP fill for platform {plat!r}; "
            f"supported: {', '.join(sorted(_FILLS))}")
    return plat


def fill_impl(kind: str, *, sharded: bool = False, overcap: bool = False,
              device=None) -> str:
    """SCAN or KERNEL for one fill of `kind` ("linear", "band" or
    "fanin").  `sharded`: the launch spans a device mesh; `overcap`: a
    fan-in pair beyond the kernel's graph-shape caps."""
    impl = _FILLS[_platform(device)][kind]
    if sharded or overcap:
        return SCAN
    return impl

