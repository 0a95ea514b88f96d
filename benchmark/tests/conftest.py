import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips, with its reason, "
                   "where there is none")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, while the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card machine)")
    return torch.device("cuda", torch.cuda.current_device())
