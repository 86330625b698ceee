import os

# Run all tests on the host CPU as a virtual 8-device mesh, so the multi-device
# sharding logic is exercised without accelerators.  The jax config update
# below pins the platform even if jax was imported before this file ran.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# The default tier is XLA:CPU compile-bound and asserts BYTE-EXACTNESS, not
# speed: backend optimization level 0 cuts cold compiles several-fold
# without changing semantics.  The production compile path (full
# optimisation on the GPU) is covered by chip_smoke.py.  Set
# REVERIE_TEST_FULL_OPT=1 to restore full optimisation here.
if ("xla_backend_optimization_level" not in flags
        and not os.environ.get("REVERIE_TEST_FULL_OPT")):
    flags = (flags + " --xla_backend_optimization_level=0").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

from reverie_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()
