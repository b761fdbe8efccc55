"""The benchmark's CPU tests run beside other test files in parallel
workers: one intra-op thread each, restored after every module, keeps a
small cell's run at seconds instead of minutes of oversubscribed cores."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
