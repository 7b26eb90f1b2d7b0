import os
import sys

# Tests must see exactly ONE device (the dry-run sets 512 in its own
# process); also keep XLA from grabbing every core on shared CI boxes.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
