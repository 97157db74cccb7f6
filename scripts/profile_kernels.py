#!/usr/bin/env python
"""Per-operator device profile of the flagship hierarchy on one GPU.

Builds the flagship 3-D Poisson hierarchy (default 192^3) and, for each
hot operator of the solve — the fine DIA SpMV with fp32 and bf16 bands,
the fine residual, one Chebyshev smoothing call on level 0, the ELL
SpMVs of P0, R0 and A1, the dense coarse-inverse apply — records:

* kernels per call and their names, from a jax.profiler trace;
* device time per call (sum of that call's kernel durations in the trace)
  and wall time per call (back-to-back calls, one final block);
* the bytes the operator must move (utils/accounting.py's op_bytes model,
  stated per op below) and the achieved rate as a share of a 1 GiB copy
  measured in the same process and of the published peak.

Prints the card's name and power limit first and one JSON line per op;
the full record goes to --out.

Usage: python scripts/profile_kernels.py [--n 192] [--reps 50] [--out F]
"""
import argparse
import dataclasses
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def device_events(trace_dir: str) -> list:
    """(name, duration_ns) of every kernel on a GPU stream in the trace
    (planes "/device:GPU:<i>", lines "Stream #<k>(...)")."""
    from jax.profiler import ProfileData
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                out.extend((e.name, e.duration_ns) for e in line.events)
    return out


def profile_op(fn, args, reps: int) -> dict:
    """Device and wall time per call of a jitted fn(*args)."""
    import jax
    jax.block_until_ready(fn(*args))             # compile + warm
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn(*args)
    jax.block_until_ready(y)
    wall = (time.perf_counter() - t0) / reps
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                y = fn(*args)
            jax.block_until_ready(y)
        ev = device_events(d)
    names = sorted({n for n, _ in ev})
    return {"wall_us": wall * 1e6,
            "device_us": sum(t for _, t in ev) / reps / 1e3,
            "kernels_per_call": len(ev) / reps,
            "kernel_names": names[:12]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default="profile_kernels.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sparsh_amg_tpu.utils.compile_cache import enable_compile_cache
    from sparsh_amg_tpu.utils.meminfo import (require_gpu, gpu_name_power,
                                              hbm_spec_bw)
    enable_compile_cache()
    devs = require_gpu()
    card = gpu_name_power()
    print(f"card: {card}", flush=True)
    from sparsh_amg_tpu.models.poisson import poisson3d
    from sparsh_amg_tpu.params import KrylovParams, flagship_params
    from sparsh_amg_tpu.solve.solver import AMGSolver
    from sparsh_amg_tpu.solve.smoothers import chebyshev
    from sparsh_amg_tpu.ops.formats import residual
    from sparsh_amg_tpu.utils.accounting import op_bytes
    from sparsh_amg_tpu.utils.timing import measure_copy_bw

    params = flagship_params()
    A = poisson3d(args.n)
    solver = AMGSolver(A, params, KrylovParams(loop_mode="device"))
    dev = solver.device
    l0, l1, lc = dev.levels[0], dev.levels[1], dev.levels[-1]
    rng = np.random.default_rng(0)
    vec = lambda m: jnp.asarray(rng.standard_normal(m).astype(np.float32))
    x0, b0 = vec(l0.n_pad), vec(l0.n_pad)
    x1 = vec(l1.n_pad)
    xc = vec(lc.n_pad)
    v4 = l0.n_pad * 4
    deg = params.cheby_degree
    band0 = l0.A.bands.size * l0.A.bands.dtype.itemsize
    l0_f32 = dataclasses.replace(l0, A=solver.A_df.A_hi)
    band0_f32 = solver.A_df.A_hi.bands.size * 4
    spmv = jax.jit(lambda op, v: op.spmv(v))
    cheb = jax.jit(lambda lv, b, x: chebyshev(lv, b, x, deg,
                                              params.cheby_lower_frac))
    ops = [
        ("fine DIA SpMV fp32 bands", spmv, (solver.A_df.A_hi, x0),
         op_bytes(solver.A_df.A_hi)),
        (f"fine DIA SpMV {l0.A.bands.dtype} bands", spmv, (l0.A, x0),
         op_bytes(l0.A)),
        ("fine residual fp32 bands", jax.jit(residual),
         (solver.A_df.A_hi, x0, b0), op_bytes(solver.A_df.A_hi) + v4),
        # deg band passes; vector streams if each stage is one pass:
        # stage 0 reads x, b, dinv and writes d (4); each later stage
        # reads x, d, r, dinv and writes x, r, d (7); x + d (3)
        (f"fine residual {l0.A.bands.dtype} bands", jax.jit(residual),
         (l0.A, x0, b0), op_bytes(l0.A) + v4),
        (f"Chebyshev degree {deg} on L0 ({l0.A.bands.dtype} bands)", cheb,
         (l0, b0, x0), deg * band0 + (4 + 7 * (deg - 1) + 3) * v4),
        (f"Chebyshev degree {deg} on L0 (fp32 bands)", cheb,
         (l0_f32, b0, x0),
         deg * band0_f32 + (4 + 7 * (deg - 1) + 3) * v4),
        (f"ELL P0 (K={l0.P.k})", spmv, (l0.P, x1), op_bytes(l0.P)),
        (f"ELL R0 (K={l0.R.k})", spmv, (l0.R, x0), op_bytes(l0.R)),
        (f"{type(l1.A).__name__} A1", spmv, (l1.A, x1), op_bytes(l1.A)),
        (f"dense coarse inverse (n={lc.n})",
         jax.jit(lambda lv, v: lv.coarse_solve(v)), (lc, xc),
         lc.coarse_inv.size * 4 + 2 * lc.coarse_inv.shape[-1] * 4),
    ]
    copy_bw = measure_copy_bw()
    peak = hbm_spec_bw()
    print(f"copy 1 GiB: {copy_bw / 1e9:.1f} GB/s "
          f"({copy_bw / peak:.3f} of the {peak / 1e12:.2f} TB/s peak) "
          f"[card: {card}]", flush=True)
    rec = {"card": card, "device_kind": devs[0].device_kind,
           "n": int(A.shape[0]), "nnz": int(A.nnz),
           "copy_GBs": copy_bw / 1e9, "peak_GBs": peak / 1e9, "ops": []}
    for name, fn, fargs, nbytes in ops:
        r = profile_op(fn, fargs, args.reps)
        t = r["device_us"] * 1e-6 if r["device_us"] > 0 else \
            r["wall_us"] * 1e-6
        r.update(name=name, bytes=int(nbytes), GBs=nbytes / t / 1e9,
                 share_of_copy=nbytes / t / copy_bw,
                 share_of_peak=nbytes / t / peak)
        rec["ops"].append(r)
        print(json.dumps(r), flush=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
