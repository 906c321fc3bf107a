"""The port's CPU tests on one intra-op thread: their tensors are small,
so a module runs faster on one thread than on many, and the test workers
share the machine's cores. A test module takes the fixture by importing
it (``from torch_threads import one_torch_thread``)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
