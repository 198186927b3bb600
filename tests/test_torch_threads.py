"""One torch thread for the port's tests (no tests of its own).

The tier-1 run puts six pytest workers on the machine's cores. With
torch's default of one intra-op thread per core, each worker's many small
CPU ops open OpenMP parallel regions whose threads wait at barriers for
threads the other workers have taken the cores from: six copies of
tests/test_torch_render_cli.py's end-to-end test took 427 s each side by
side with 8 threads and 12 s each with 1, against 20 s alone. Every
port test module imports `one_torch_thread`, an autouse module fixture
that runs the module's tests with one intra-op thread and gives the
worker back its count after them, so the JAX package's own tests in the
same worker run as before.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
