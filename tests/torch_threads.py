"""One torch thread for a port test module.

A port test steps 1 to 16 envs at a time, too few for torch's intra-op
pool to share out. Under ``pytest -n 6`` six workers each run that pool
at one thread per core of an 8-core host, and its threads then spin
against each other: the port's tests took ~4x the time they take on
one thread. Import the fixture into a ``tests/test_torch_*.py`` module::

    from torch_threads import one_torch_thread  # noqa: F401

by this module's own name, which pytest finds beside the test modules: on
the machine with the card another project's ``tests`` package can shadow
this folder, and ``tests/test_torch_tracing.py`` runs there.

It pins torch's pool only, and only while that module's tests run, so
that the other modules a worker runs keep their own settings. The card
tests (``tests/test_torch_cuda.py``) do not import it: their CPU
references run at 1024 envs, alone.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's intra-op pool at one thread for the module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
