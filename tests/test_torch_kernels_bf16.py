"""Card tests of bf16 storage: the passes' storage instantiations (the
bf16 state on every rung, the bf16 metric under highest and split2m) and
B2's f32 carry on a z-slab (C10), each against its plain version with its
control, by ``utils/bf16_state_check.compare_all`` at one degree a test,
on the 3 x 5 x 7 box (105 cells: no multiple of a block's cells).  Each
test is marked ``cuda`` and skips with a reason without one.  This file
imports no JAX (run it with ``--noconftest``, as
``tests/test_torch_kernels.py``)."""

import pytest
import torch

from mf_data_locality_tpu_torch.utils import bf16_state_check


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p", range(1, 12))
def test_bf16_storage_matches_plain(cuda_device, p):
    """At degree p every storage instantiation against its plain version
    (relative L2 3e-4 for bf16 vectors, 1e-5 for f32 ones beside a bf16
    metric, B2's scalars 1e-4), each control outside its limit; C10's
    carry at p=2 and 4 (1e-5, the face as stored outside it)."""
    worst = bf16_state_check.compare_all(
        cuda_device, degrees=(p,), carry_degrees=(p,) if p in (2, 4) else ())
    assert worst
