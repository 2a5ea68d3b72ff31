"""pytest settings of the benchmark's own tests (``perfbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; decided inside the test, skipped without one")
