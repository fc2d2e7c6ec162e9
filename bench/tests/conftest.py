"""The benchmark's CPU tests run their smoke-size work on one thread:
many threads only wait on each other, and on a busy host, at these
sizes.  The setting is restored after each module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
