"""What the GPU path relies on, checked on the CPU: chip_smoke.py's
helpers and parity checks at a small size, the compile-cache rule, the
published-peak table, and full fp32 precision on every dense product."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import chip_smoke
from sparsh_amg_tpu.ops import blas
from sparsh_amg_tpu.ops.formats import DenseMatrix
from sparsh_amg_tpu.parallel.dist import DistDense, ReplSrc, pdot
from sparsh_amg_tpu.parallel.hierarchy import DistLevel
from sparsh_amg_tpu.parallel.solver import default_mesh
from sparsh_amg_tpu.solve.device import DeviceLevel
from sparsh_amg_tpu.utils import compile_cache, meminfo

HIGHEST = jax.lax.Precision.HIGHEST


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        meminfo.require_gpu()


def test_peak_table_raises_on_unknown_kind():
    class Dev:
        device_kind = "Some Unknown Accelerator"
    with pytest.raises(KeyError, match="no published peaks"):
        meminfo.hbm_spec_bw(Dev())
    with pytest.raises(KeyError):
        meminfo.hbm_spec_bw(jax.devices()[0])       # the CPU


def test_peak_table_h100():
    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"
    assert meminfo.hbm_spec_bw(Dev()) == 3.35e12
    assert meminfo.device_peaks(Dev())["hbm_bytes"] == 80e9


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.DEFAULT_DIR
        assert path.endswith("/.jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "unchanged")
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper sets nothing
        assert jax.config.jax_compilation_cache_dir == "unchanged"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_result_line_shape():
    line = chip_smoke.result_line(jax.devices()[:1])
    assert "\n" not in line
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": 1}}


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_row_bound_ratio():
    y_ref = np.array([1.0, -2.0, 0.0])
    scale = np.array([1.0, 2.0, 0.0])
    assert chip_smoke.row_bound_ratio(y_ref, y_ref, scale, 1e-7) == 0.0
    r = chip_smoke.row_bound_ratio(y_ref + [1e-7, 0, 0], y_ref, scale, 1e-7)
    assert r == pytest.approx(1.0)
    assert chip_smoke.row_bound_ratio(y_ref + [0, 0, 1e-9], y_ref, scale,
                                      1e-7) == np.inf


def test_flagship_phase_small():
    """chip_smoke.py phases 2-3 (every parity check, then the solve with
    its float64 true-residual check) at 16^3 on the CPU."""
    chip_smoke.flagship_phase("cpu", n=16)


def test_elasticity_phase_small():
    """chip_smoke.py phase 4 on scripts/run_configs.py's elasticity3d
    row at a reduced size (m=5)."""
    chip_smoke.elasticity_phase("cpu", scale=8)


def test_four_card_phase_small():
    """The --four path (global-setup and process-local DistAMGSolver vs
    the one-device solve) on four virtual CPU devices at 24^3 (the
    smallest size with a blocked level above the replication size)."""
    chip_smoke.four_card_phase("cpu", n=24)


def _dots(jaxpr):
    """Every dot_general equation of a jaxpr, nested ones included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dots(inner))
    return out


def _assert_highest(fn, *args):
    dots = _dots(jax.make_jaxpr(fn)(*args).jaxpr)
    assert dots, "no dot_general traced"
    for eqn in dots:
        assert eqn.params["precision"] == (HIGHEST, HIGHEST), eqn


def _sharded(body, nd=4):
    mesh = default_mesh(nd)
    return jax.shard_map(body, mesh=mesh, in_specs=P("rows"),
                         out_specs=P("rows"), check_vma=False)


@pytest.mark.parametrize("case", ["dense", "coarse_inv", "blas_dot",
                                  "dist_dense", "repl_src", "dist_coarse",
                                  "pdot"])
def test_dense_products_use_highest_precision(case):
    x = jnp.ones(256, jnp.float32)
    mat = jnp.ones((256, 256), jnp.bfloat16)
    if case == "dense":
        D = DenseMatrix(mat=mat, n_rows=256, n_cols=256, out_pad=256)
        _assert_highest(D.spmv, x)
    elif case == "coarse_inv":
        lev = DeviceLevel(A=None, dinv=x, l1_dinv=x, lam_max=x[0], P=None,
                          R=None, coarse_inv=jnp.ones((256, 256)), n=256)
        _assert_highest(lev.coarse_solve, x)
    elif case == "blas_dot":
        _assert_highest(lambda v: blas.dot(v, v, compensated=False), x)
    elif case == "dist_dense":
        op = DistDense(mat=jnp.ones((4, 64, 256)), nd=4, axis="rows",
                       n_rows=256, n_cols=256)
        _assert_highest(_sharded(lambda v: op.local().spmv(v)), x)
    elif case == "repl_src":
        op = ReplSrc(op=DistDense(mat=jnp.ones((64, 256)), nd=4,
                                  axis="rows", n_rows=256, n_cols=256))
        _assert_highest(lambda v: op.spmv(v), x)
    elif case == "dist_coarse":
        lev = DistLevel(A=None, dinv=x, l1_dinv=x, lam_max=x[0], P=None,
                        R=None, coarse_inv=jnp.ones((64, 256)), n=256)
        _assert_highest(_sharded(lev.coarse_solve), x)
    else:
        _assert_highest(_sharded(
            lambda v: pdot(v, v, "rows", compensated=False)[None]
            * jnp.ones_like(v)), x)
