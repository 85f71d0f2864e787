import os
import sys

# smoke tests and benches must see ONE device — the 512-device env var is
# set exclusively inside launch/dryrun.py (see that module's docstring)
assert "xla_force_host_platform_device_count" not in \
    os.environ.get("XLA_FLAGS", ""), \
    "dry-run XLA_FLAGS leaked into the test environment"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; such a test skips without one")
