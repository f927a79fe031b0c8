import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the toy cells' ops are small, and with several
    test workers on the machine each worker's thread pool would wait on
    the others'."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)
