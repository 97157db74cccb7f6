"""Test configuration.

Tests run on the CPU backend with 8 virtual devices (SURVEY.md §4.4: the
JAX-native 'fake backend' for exercising shard_map halo exchange and
agglomeration without several cards), keeping CI deterministic and fast;
the GPU path is exercised by chip_smoke.py and bench.py on the card.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sparsh_amg_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compile cache: first-op eager compiles cost ~1s each on this
# CPU backend; caching makes repeat test runs fast.
enable_compile_cache()
