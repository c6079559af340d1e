"""paddle_tpu_torch.tensor's manipulation, creation, logic, search, stat
and attribute functions in dygraph mode, held against paddle_tpu.tensor
on the CPU (tests/test_torch_tensor_eager.py says how; the case tables:
tests/torch_tensor_cases.py).  The orders the JAX kernels pin have cases
of their own: top_k's ties and NaNs (XLA's total order, the lower index
first), argsort's NaNs (last, whatever their sign), argmax's first
extreme (a NaN counting as both), unique's first occurrences and its one
NaN."""
import pytest
import torch

from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.dygraph import guard

from torch_tensor_cases import MANIP_CASES, check_case


@pytest.fixture(autouse=True)
def _cpu():
    torch.set_num_threads(2)
    with guard(CPUPlace()):
        yield


@pytest.mark.parametrize("name", sorted(MANIP_CASES))
def test_function_matches_the_jax_package(name):
    check_case(name)
