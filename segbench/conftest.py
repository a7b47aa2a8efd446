"""pytest settings of the benchmark's own tests (``segbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; decided inside the test, skipped without one")
