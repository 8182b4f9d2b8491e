"""The benchmark's tests: register the `cuda` marker (a test that needs an
NVIDIA card decides inside itself whether there is one, and skips)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips on a CPU-only machine")
