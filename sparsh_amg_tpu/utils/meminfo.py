"""Device-memory accounting (SURVEY.md §2 C23: the reference tracks GPU
hierarchy bytes to decide level placement; here the frozen pytrees make the
count a tree walk).

Two views:
- `tree_device_bytes(obj)`: bytes of every jax.Array leaf in a pytree —
  the persistent footprint of a frozen hierarchy / df64 operator.
- `device_memory_stats()`: the live allocator view from the backend
  (peak / in use), when the platform exposes it (GPUs do; CPU returns {}).
"""
from __future__ import annotations

import subprocess

import jax


def tree_device_bytes(obj) -> int:
    """Total bytes of jax.Array leaves in a pytree (0 for host leaves)."""
    total = 0
    for leaf in jax.tree_util.tree_leaves(obj):
        if isinstance(leaf, jax.Array):
            total += leaf.nbytes
    return total


# Published peaks by device kind, keyed on jax's ``device_kind``: NVIDIA
# H100 data sheet (SXM part), 3.35 TB/s HBM3 bandwidth and 80 GB of device
# memory.  A kind missing here is an error: a roofline share against an
# assumed peak would be a made-up number.
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "hbm_bytes": 80e9},
}


def device_peaks(device=None) -> dict:
    """Published peaks of the attached device (see _DEVICE_PEAKS)."""
    if device is None:
        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    if kind not in _DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(_DEVICE_PEAKS)}")
    return _DEVICE_PEAKS[kind]


def hbm_spec_bw(device=None) -> float:
    """Published device-memory bandwidth (bytes/s) of the attached chip."""
    return device_peaks(device)["hbm_bytes_per_s"]


def device_memory_stats(device=None) -> dict:
    """Allocator stats from the backend (bytes_in_use, peak_bytes_in_use,
    bytes_limit, ...) or {} when the platform doesn't report them."""
    if device is None:
        device = jax.local_devices()[0]
    try:
        stats = device.memory_stats()
    except Exception:
        return {}
    return dict(stats) if stats else {}


def require_gpu() -> list:
    """The JAX devices, which must be GPUs: a measurement or smoke run on
    any other platform is refused rather than silently run on the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU found: JAX's first device is "
                           f"{devs[0].platform!r} ({devs[0].device_kind})")
    return devs


def gpu_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them, to
    print beside every number measured on it (one line per distinct
    card: identical cards of one host collapse to one line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = [l.strip() for l in out.stdout.splitlines() if l.strip()]
    return "; ".join(dict.fromkeys(lines))
