"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests validate numerics and the multi-device sharding path without a GPU
(SURVEY.md section 4 item 4): kernels run through the Pallas interpreter,
and the card itself is exercised by chip_smoke.py.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _free_compiled_executables():
    """Drop JIT caches after every test module.

    One pytest process compiles hundreds of XLA CPU programs over the
    full suite; each JIT'd executable holds mmap'd code/data sections,
    and the process crosses the kernel's vm.max_map_count (65530 here)
    around the ~90th test — LLVM then fails with 'Cannot allocate
    memory' and the interpreter segfaults (observed twice at
    test_parity_contract). Clearing per module keeps the map count
    bounded at the cost of recompiling shared programs (~minutes over
    the suite)."""
    yield
    import jax

    jax.clear_caches()
    gc.collect()
