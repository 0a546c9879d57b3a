import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions run tiny tensor ops one at a time: one intra-op
    thread keeps several test workers on one machine from contending for
    its cores.  Restored after each test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
