"""The benchmark's own tests (`python -m pytest benchmark/tests`), apart from
the repository's `tests/`. Tests marked `card` need a CUDA card; they
decide so in the `card` fixture and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return torch.device("cuda", 0)
