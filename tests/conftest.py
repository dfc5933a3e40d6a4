"""Test session configuration.

The ring-collective kernels and the comms backends are *multi-PE by nature*,
so the test session runs with 8 simulated host devices (deliberate, documented
choice — this is NOT the 512-device dry-run flag, which only
repro.launch.dryrun sets for itself).  Model smoke tests ignore the extra
devices (plain jit places on device 0).
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import pytest  # noqa: E402

# --- jax API compat ---------------------------------------------------------
# The tests target the current jax surface; older installs (e.g. 0.4.x) spell
# these differently.  Shim only what is missing so new jax runs untouched.
# The shard_map shim is shared with the benchmark harness (one copy).

from repro._jaxcompat import ensure_jax_compat  # noqa: E402

ensure_jax_compat()

try:
    _am = jax.sharding.AbstractMesh((1,), ("_probe",))
    del _am
except TypeError:                                 # old ctor: ((name, size), ...)
    _OldAbstractMesh = jax.sharding.AbstractMesh

    def _compat_abstract_mesh(axis_sizes, axis_names=None, **kwargs):
        if axis_names is None:
            return _OldAbstractMesh(axis_sizes, **kwargs)
        return _OldAbstractMesh(tuple(zip(axis_names, axis_sizes)), **kwargs)

    jax.sharding.AbstractMesh = _compat_abstract_mesh


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs the port's kernels); "
                   "skipped without one")


@pytest.fixture(scope="session")
def mesh8():
    return jax.make_mesh((8,), ("x",))


@pytest.fixture(scope="session")
def mesh2x4():
    return jax.make_mesh((2, 4), ("data", "model"))
