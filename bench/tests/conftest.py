"""The benchmark's tests: the ``gpu`` marker of card-only cases (each
decides inside the test whether a card is there)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one"
    )
