"""portbench's CPU tests run torch at two threads."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
