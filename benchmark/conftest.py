"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark``): the ``cuda`` marker of tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false")
