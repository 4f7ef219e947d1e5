import jax

jax.config.update("jax_platform_name", "cpu")
# NOTE: no xla_force_host_platform_device_count here — smoke tests and
# benches must see 1 device; only launch/dryrun.py requests 512.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
