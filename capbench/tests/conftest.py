"""The benchmark's own test settings: the `cuda` marker, and the fixture
that decides, inside a test, whether there is a card."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
