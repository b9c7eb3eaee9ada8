"""One intra-op thread for torch in every test process of the port, and a
``tmp_path`` that does not outlive a passing test.

The tier-1 command runs the tests in six pytest-xdist workers on one host.
Left alone, torch gives each worker as many OpenMP threads as the host has
cores, and the plain PyTorch twins of the kernels issue thousands of tiny
ops per solve: the workers' spinning threads then take turns on the cores,
and a solve that takes 0.4 s on one thread takes minutes. Every
``tests/test_torch_*.py`` imports this module before anything else.
"""

import shutil

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def tmp_path(tmp_path, request):
    """pytest's ``tmp_path``, removed once its test has passed.

    A fit of the port writes each snapshot family at PCRNet's full width
    (~50 MB with Adam's moments, ~150 MB a fit). Kept, the port's tests
    leave ~12 GB under the temp directory in one tier-1 run, and pytest
    keeps the last three runs' directories. A failing test's directory
    stays, to be looked at. Test files that use ``tmp_path`` import this
    fixture by name, which overrides pytest's own for their tests.
    """
    failed = request.session.testsfailed
    yield tmp_path
    if request.session.testsfailed == failed:
        shutil.rmtree(tmp_path, ignore_errors=True)
