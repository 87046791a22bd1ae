"""pytest settings of the benchmark's own tests (portbench/tests)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips (deciding inside the "
        "test) where torch.cuda.is_available() is false")
