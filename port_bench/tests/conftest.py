"""The benchmark's own tests: ``python -m pytest port_bench/tests`` from the
repository root (CPU); ``python -m pytest -m gpu port_bench/tests`` on a
card.  Tests marked ``gpu`` decide inside the test whether a card is
there."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
