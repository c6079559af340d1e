"""paddle_tpu_torch.tensor in dygraph mode, held against paddle_tpu.tensor
on the CPU: the math, linalg and compat functions here, the others in
tests/test_torch_tensor_manip.py (the case tables: tests/
torch_tensor_cases.py).  Every function of both packages'
`tensor.__all__` and `tensor.compat.__all__` runs on the same numpy
inputs in either package and the outputs agree (fp32 1e-6,
transcendental functions 1e-5, integers and booleans by value: the
port's index outputs are int64, compared by value).  Where a function is
differentiable the gradients of sum(out * w) with respect to its float
inputs agree too (1e-5).  The random functions draw other numbers in
each package (Philox against threefry): there the shapes, dtypes and
ranges agree (tests/test_torch_tensor_random.py holds the draws
themselves)."""
import pytest
import torch

import paddle_tpu
import paddle_tpu.tensor as J
import paddle_tpu.tensor.compat as JC

import paddle_tpu_torch as pt
import paddle_tpu_torch.tensor as T
import paddle_tpu_torch.tensor.compat as TC
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.dygraph import guard

from torch_tensor_cases import (CASES, MATH_CASES, RANDOM, check_case,
                                check_random)
from test_torch_gpt import jax_generator_restored  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu():
    torch.set_num_threads(2)
    with guard(CPUPlace()):
        yield


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_function_matches_the_jax_package(name):
    check_case(name)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_function_shapes_and_ranges(name):
    check_random(name)


def test_every_name_has_a_case():
    import torch_tensor_cases
    names = set(J.__all__) | set(JC.__all__)
    assert set(T.__all__) == set(J.__all__)
    assert set(TC.__all__) == set(JC.__all__)
    src = open(torch_tensor_cases.__file__).read()
    missing = sorted(n for n in names
                     if f"M.{n}(" not in src and f"C.{n}(" not in src
                     and f'"{n}"' not in src
                     and n not in ("Tensor", "create_parameter",
                                   "create_global_var", "crop_tensor",
                                   "get_tensor_from_selected_rows"))
    assert not missing, missing
    assert len(CASES) > 100
    # the names that take no call here are the package's types and the
    # static-graph builders, static-only in the JAX package too
    # (tests/test_torch_tensor_static.py)
    assert T.Tensor is torch.Tensor


def test_top_level_exports():
    for n in J.__all__ + JC.__all__:
        assert hasattr(pt, n), n
    for n in ("enable_static", "disable_static", "in_dynamic_mode",
              "get_default_dtype", "set_default_dtype"):
        assert hasattr(pt, n) and hasattr(paddle_tpu, n), n
    from paddle_tpu_torch import amp
    assert amp.AmpScaler is amp.GradScaler
