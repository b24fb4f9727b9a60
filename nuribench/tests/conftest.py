"""The marker of the benchmark's tests that need a CUDA card (run them on
the card with ``python -m pytest nuribench/tests -m card``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")
