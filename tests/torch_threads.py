"""A module fixture for the port's CPU tests: torch on one thread.

The tests' models are tiny, so torch's CPU threads gain them nothing, and
under the suite's parallel workers (``-n 6``) those threads contend
for the cores with every other worker. A test module takes it with
``from torch_threads import one_thread  # noqa: F401`` (autouse)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
