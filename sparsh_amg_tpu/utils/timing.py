"""Phase timers and kernel benchmarking (SURVEY.md §2 C25: the reference
reports wall-clock per phase and per-kernel CUDA-event timings; here
perf_counter + block_until_ready, reporting nnz/s and GFLOP/s against the
speed-of-light bound)."""
from __future__ import annotations

import time
from contextlib import contextmanager

import jax


class Timer:
    """Accumulating named phase timer."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(
            f"{k:>24s}: {v:9.4f}s  (x{self.counts[k]})"
            for k, v in sorted(self.times.items()))


def benchmark_op(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median wall-clock seconds of fn(*args) with block_until_ready."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def speed_of_light_spmv_nnz_per_s(hbm_bw_bytes: float,
                                  bytes_per_nnz: float = 12.0) -> float:
    """Upper bound on SpMV nnz/s: HBM bandwidth / bytes moved per nonzero
    (fp32 value + int32 column + amortized x/y traffic; DIA layouts drop the
    column index and approach 6-8 B/nnz)."""
    return hbm_bw_bytes / bytes_per_nnz


_RTT_CACHE: dict[str, float] = {}


def measure_dispatch_rtt(reps: int = 5) -> float:
    """Median seconds for one tiny jitted dispatch + blocking scalar
    readback — the per-dispatch cost the host-chunked Krylov loop pays at
    every convergence check.  Inputs are fresh per rep.  Cached per
    backend for the life of the process."""
    import jax.numpy as jnp
    key = jax.default_backend()
    if key in _RTT_CACHE:
        return _RTT_CACHE[key]
    f = jax.jit(lambda x: x * 1.0000001)
    jax.block_until_ready(f(jnp.zeros((8,), jnp.float32)))   # compile
    ts = []
    for i in range(reps):
        x = jnp.full((8,), float(i + 1), dtype=jnp.float32)
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        float(f(x)[0])
        ts.append(time.perf_counter() - t0)
    ts.sort()
    rtt = ts[len(ts) // 2]
    _RTT_CACHE[key] = rtt
    return rtt


def resolve_loop_mode(mode: str, threshold_s: float = 1e-3) -> str:
    """loop_mode="auto" -> "device" when the measured per-dispatch RTT is
    below ``threshold_s`` (direct-attached: the single-dispatch while_loop
    needs the fewest iterations and pays no per-check launch), else
    "host" (slow links, where the per-while-iteration sync dominates)."""
    if mode != "auto":
        return mode
    return "device" if measure_dispatch_rtt() < threshold_s else "host"


def measure_copy_bw(nbytes: int = 1 << 30, reps: int = 20) -> float:
    """Measured device copy bandwidth (read + write) in bytes/s of
    y = x * a over `nbytes` of fp32.  The default 1 GiB is 20x an H100's
    50 MB L2, so the copy streams device memory.  The `reps` passes are
    separate launches queued back to back (a chain inside one jit would
    fuse into a single pass); one pass takes far longer than a launch,
    so launch overhead stays hidden."""
    import jax.numpy as jnp
    n = nbytes // 4
    f = jax.jit(lambda v: v * 1.0000001)
    x = jnp.ones((n,), dtype=jnp.float32)
    x = f(x).block_until_ready()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        y = x
        for _ in range(reps):
            y = f(y)
        y.block_until_ready()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return 2 * n * 4 * reps / ts[1]
