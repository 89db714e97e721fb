"""Test-suite bootstrap: register markers and, when the real ``hypothesis``
package is missing (hermetic container), alias the deterministic fallback in
``tests/_hypothesis_fallback.py`` into ``sys.modules`` before test modules
import it. CI installs real hypothesis, so the fallback is exercised only
where pip installs are unavailable."""
import importlib.util
import os
import sys

if importlib.util.find_spec("hypothesis") is None:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_fallback
    sys.modules["hypothesis"] = _hypothesis_fallback


import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches_per_module():
    """Clear jax's compilation caches after each test module.

    The full suite compiles thousands of distinct XLA programs in one
    process; on the CPU backend the accumulated LLVM JIT state eventually
    segfaults inside ``backend_compile`` (observed around ~450 modules'
    worth of executables). Module-scoped cache drops keep the resident
    executable count bounded without perturbing the warm-jit-signature
    assertions, which all live within a single module.
    """
    yield
    import jax

    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (minutes on CPU)")
    config.addinivalue_line(
        "markers", "interpret: interpret-mode Pallas kernel validation "
        "(split into its own CI job)")
    config.addinivalue_line(
        "markers", "autotune: measured kernel-config search (wall-clock "
        "timing; own CI job)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (repro_torch's hand-written "
        "kernels); skips without one")
