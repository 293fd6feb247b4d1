"""Two PyTorch intra-op threads for a test module: the Tier-1 command runs six
pytest-xdist workers, and PyTorch's default of a thread a core oversubscribes
the cores (test_torch_trainer.py's run against JAX took 296 s instead of 34 s).
A module takes it with `from _torch_threads import two_torch_threads`.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
