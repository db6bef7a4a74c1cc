import jax
import pytest

# NOTE: no xla_force_host_platform_device_count here — tests must see the
# real (single) device; only launch/dryrun.py forces 512.

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one (run on "
        "the card with: python -m pytest -m cuda tests/test_torch_cuda.py)")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
