import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads a test: test workers on one host that each ask
    for every core slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
