"""Test settings of the benchmark's own tests (``python -m pytest port_bench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped where there is none")
