"""The PyTorch port's tests' thread setting: a module imports
``_one_thread`` (``from torch_threads import _one_thread``) to run its
torch work on one intra-op thread."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the importing module's torch work: the
    tier-1 run shares the CPU among several pytest workers, where torch's
    oversubscribed parallel regions slow renders many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
