"""The case tables of tests/test_torch_tensor_eager.py and
tests/test_torch_tensor_manip.py: every paddle.tensor / compat function,
with the same numpy inputs for both packages, and the check that runs a
case in both (outputs, then gradients of sum(out * w))."""
import zlib

import numpy as np
import torch

import paddle_tpu
import paddle_tpu.tensor as J
import paddle_tpu.tensor.compat as JC

import paddle_tpu_torch as pt
import paddle_tpu_torch.tensor as T
import paddle_tpu_torch.tensor.compat as TC

F32 = np.float32
TOL = {"f": dict(rtol=1e-6, atol=1e-6), "t": dict(rtol=1e-5, atol=1e-5)}
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _u(r, *shape):
    return r.uniform(-1, 1, shape).astype(F32)


def _pos(r, *shape):
    return r.uniform(0.2, 2.0, shape).astype(F32)


def _i(r, hi, *shape):
    return r.randint(0, hi, shape).astype(np.int64)


def _spd(r, n):
    a = r.rand(n, n).astype(np.float64)
    return (a @ a.T + n * np.eye(n)).astype(F32)


NAN = np.nan
TIES = np.array([[1.0, NAN, 3.0, 3.0, 2.0, -NAN, 0.0, -0.0],
                 [2.0, 2.0, 2.0, 1.0, 1.0, 5.0, 5.0, 0.0]], F32)

# name -> (fn(M, C, *tensors), inputs(rng) -> [numpy], kind, grad)
#   M: the package's tensor module, C: its compat module.  MATH_CASES:
# tensor/{math,linalg,compat}.py; MANIP_CASES: tensor/{manipulation,
# creation,logic,search,stat,attribute}.py
MATH_CASES = {
    # -- unary math --------------------------------------------------------
    **{f"unary_{n}": ((lambda n: lambda M, C, x: getattr(M, n)(x))(n),
                      (lambda n: lambda r: [
                          _pos(r, 3, 4) * (0.45 if n in ("asin", "acos")
                                           else 1.0)])(n),
                      "t", n not in ("ceil", "floor", "round", "sign"))
       for n in ("exp", "sqrt", "rsqrt", "abs", "ceil", "floor", "round",
                 "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
                 "cosh", "tanh", "reciprocal", "square", "sign", "erf",
                 "log", "log2", "log10", "log1p", "sigmoid")},
    "round_halves": (lambda M, C, x: M.round(x),
                     lambda r: [np.array([0.5, 1.5, 2.5, -0.5, -2.5], F32)],
                     "f", False),
    # -- binary math -------------------------------------------------------
    **{f"binary_{n}": ((lambda n: lambda M, C, x, y: getattr(M, n)(x, y))(n),
                       lambda r: [_pos(r, 3, 4), _pos(r, 4)],
                       "t", n in ("add", "subtract", "multiply", "divide",
                                  "maximum", "minimum", "pow"))
       for n in ("add", "subtract", "multiply", "divide", "floor_divide",
                 "remainder", "mod", "floor_mod", "pow", "maximum",
                 "minimum")},
    "binary_scalar": (lambda M, C, x: M.add(M.multiply(x, 3.0), 1.5),
                      lambda r: [_u(r, 3, 4)], "f", True),
    "int_floor_divide": (lambda M, C, x, y: M.floor_divide(x, y),
                         lambda r: [_i(r, 20, 3, 4) - 10,
                                    _i(r, 4, 3, 4) + 1], "i", False),
    "pow_scalar": (lambda M, C, x: M.pow(x, 3), lambda r: [_pos(r, 5)],
                   "t", True),
    # -- reductions --------------------------------------------------------
    **{f"reduce_{n}_{ax}": (
        (lambda n, ax: lambda M, C, x: getattr(M, n)(
            x, axis=ax, keepdim=ax == 1))(n, ax),
        lambda r: [_pos(r, 3, 4, 2)], "t", n in ("sum", "mean", "max",
                                                 "min", "prod"))
       for n in ("sum", "mean", "max", "min", "prod", "logsumexp")
       for ax in (None, 1, [0, 2])},
    "reduce_all_any": (lambda M, C, x: [M.all(x, axis=1), M.any(x),
                                        M.all(x, axis=[0, 1],
                                              keepdim=True)],
                       lambda r: [r.rand(3, 4) > 0.3], "i", False),
    "sum_dtype": (lambda M, C, x: M.sum(x, axis=0, dtype="float64"),
                  lambda r: [_u(r, 3, 4)], "f", False),
    "prod_dtype": (lambda M, C, x: M.prod(x, axis=1, dtype="float64"),
                   lambda r: [_pos(r, 3, 4)], "t", False),
    # -- other math --------------------------------------------------------
    "scale": (lambda M, C, x: [M.scale(x, 2.0, 0.5),
                               M.scale(x, 2.0, 0.5, False, act="tanh")],
              lambda r: [_u(r, 3, 4)], "t", True),
    "clip": (lambda M, C, x: [M.clip(x, -0.3, 0.4), M.clip(x, max=0.1)],
             lambda r: [_u(r, 3, 4)], "f", True),
    "cumsum": (lambda M, C, x: [M.cumsum(x, 1), M.cumsum(x),
                                M.cumsum(x, 0, dtype="float64")],
               lambda r: [_u(r, 3, 4)], "t", True),
    "increment": (lambda M, C, x: M.increment(x, 2.0),
                  lambda r: [np.array([1.0], F32)], "f", False),
    "multiplex": (lambda M, C, a, b, i: M.multiplex([a, b], i),
                  lambda r: [_u(r, 4, 3), _u(r, 4, 3),
                             np.array([[1], [0], [1], [1]], np.int32)],
                  "f", True),
    "stanh": (lambda M, C, x: M.stanh(x, 0.5, 2.0),
              lambda r: [_u(r, 3, 4)], "t", True),
    "addmm": (lambda M, C, i, x, y: M.addmm(i, x, y, 0.5, 2.0),
              lambda r: [_u(r, 3, 5), _u(r, 3, 4), _u(r, 4, 5)], "t", True),
    "kron": (lambda M, C, x, y: M.kron(x, y),
             lambda r: [_u(r, 2, 3), _u(r, 3, 2)], "f", True),
    "trace": (lambda M, C, x: [M.trace(x), M.trace(x, 1, 1, 2)],
              lambda r: [_u(r, 3, 4, 4)], "t", True),
    "isfinite_inf_nan": (lambda M, C, x: [M.isfinite(x), M.isinf(x),
                                          M.isnan(x), C.has_inf(x),
                                          C.has_nan(x)],
                         lambda r: [np.array([1.0, np.inf, -np.inf, NAN, 0],
                                             F32)], "i", False),
    "tanh_": (lambda M, C, x: M.tanh_(M.scale(x, 1.0)),
              lambda r: [_u(r, 3, 4)], "t", False),
    # -- linalg ------------------------------------------------------------
    "matmul": (lambda M, C, x, y: [M.matmul(x, y), M.matmul(x, y, True,
                                                            False)],
               lambda r: [_u(r, 4, 4), _u(r, 4, 3)], "t", True),
    "mm": (lambda M, C, x, y: M.mm(x, y),
           lambda r: [_u(r, 3, 4), _u(r, 4, 2)], "t", True),
    "bmm": (lambda M, C, x, y: M.bmm(x, y),
            lambda r: [_u(r, 2, 3, 4), _u(r, 2, 4, 5)], "t", True),
    "dot": (lambda M, C, x, y: M.dot(x, y),
            lambda r: [_u(r, 3, 4), _u(r, 3, 4)], "t", True),
    "mv": (lambda M, C, x, v: M.mv(x, v),
           lambda r: [_u(r, 3, 4), _u(r, 4)], "t", True),
    "norm": (lambda M, C, x: [M.norm(x), M.norm(x, "fro", [0, 1]),
                              M.norm(x, 2, 1), M.norm(x, 3.0, 0, True),
                              M.norm(x, 1)],
             lambda r: [_pos(r, 3, 4)], "t", True),
    "dist": (lambda M, C, x, y: [M.dist(x, y), M.dist(x, y, 1),
                                 M.dist(x, y, float("inf")), M.dist(x, y, 0)],
             lambda r: [_u(r, 3, 4), _u(r, 3, 4)], "t", True),
    "cholesky": (lambda M, C, x: [M.cholesky(x), M.cholesky(x, True)],
                 lambda r: [_spd(r, 4)], "t", True),
    "inverse": (lambda M, C, x: M.inverse(x), lambda r: [_spd(r, 4)], "t",
                True),
    "cross": (lambda M, C, x, y: [M.cross(x, y), M.cross(x, y, 1)],
              lambda r: [_u(r, 3, 3), _u(r, 3, 3)], "t", True),
    "histogram": (lambda M, C, x: [M.histogram(x, 5), M.histogram(x, 4, -1,
                                                                   1)],
                  lambda r: [np.array([0.1, 0.5, 0.5, 0.9, -0.2, 1.0], F32)],
                  "i", False),
    "t_transpose": (lambda M, C, x: [M.t(x), M.transpose(x, [1, 0])],
                    lambda r: [_u(r, 3, 4)], "f", True),
    # -- compat ------------------------------------------------------------
    "einsum": (lambda M, C, x, y: [C.einsum("ij,jk->ik", x, y),
                                   C.einsum("ij->j", x)],
               lambda r: [_u(r, 3, 4), _u(r, 4, 2)], "t", True),
    "addcmul": (lambda M, C, a, b, c: [C.addcmul(a, b, c),
                                       C.addcmul(a, b, c, 0.5)],
                lambda r: [_u(r, 3), _u(r, 3), _u(r, 3)], "f", True),
    **{f"compat_{n}": ((lambda n: lambda M, C, x, y: getattr(C, n)(x, y))(n),
                       lambda r: [_pos(r, 3, 4), _pos(r, 4)], "t",
                       n in ("elementwise_add", "elementwise_mul",
                             "elementwise_max"))
       for n in ("elementwise_add", "elementwise_sub", "elementwise_mul",
                 "elementwise_div", "elementwise_mod", "elementwise_pow",
                 "elementwise_floordiv", "elementwise_max",
                 "elementwise_min")},
    "compat_axis": (lambda M, C, x, y: C.elementwise_add(x, y, axis=1),
                    lambda r: [_u(r, 2, 3, 4), _u(r, 3)], "f", True),
    "compat_sum": (lambda M, C, x, y: C.elementwise_sum([x, y, x]),
                   lambda r: [_u(r, 3), _u(r, 3)], "f", True),
    **{f"compat_{n}": ((lambda n: lambda M, C, x: [
        getattr(C, n)(x), getattr(C, n)(x, dim=1, keep_dim=True)])(n),
        (lambda n: lambda r: [r.rand(3, 4) > 0.3
                              if n in ("reduce_all", "reduce_any")
                              else _pos(r, 3, 4)])(n),
        "t" if n not in ("reduce_all", "reduce_any") else "i",
        n not in ("reduce_all", "reduce_any"))
       for n in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                 "reduce_prod", "reduce_all", "reduce_any")},
    "compat_fill_constant": (lambda M, C: C.fill_constant([2, 2], "float32",
                                                          3.0),
                             lambda r: [], "f", False),
}

MANIP_CASES = {
    # -- manipulation ------------------------------------------------------
    "reshape": (lambda M, C, x: [M.reshape(x, [4, -1]),
                                 M.reshape(x, [0, 2, 2])],
                lambda r: [_u(r, 3, 4)], "f", True),
    "concat": (lambda M, C, x, y: [M.concat([x, y], 1), M.concat([x, y])],
               lambda r: [_u(r, 3, 4), _u(r, 3, 4)], "f", True),
    "split": (lambda M, C, x: [*M.split(x, 2, 1), *M.split(x, [1, -1], 0),
                               *M.chunk(x, 2, 1)],
              lambda r: [_u(r, 3, 4)], "f", True),
    "stack": (lambda M, C, x, y: [M.stack([x, y], 1), M.stack([x, y], -1)],
              lambda r: [_u(r, 3, 4), _u(r, 3, 4)], "f", True),
    "unstack_unbind": (lambda M, C, x: [*M.unstack(x, 1),
                                        *M.unbind(x, 0)],
                       lambda r: [_u(r, 2, 3)], "f", True),
    "squeeze_unsqueeze": (lambda M, C, x: [M.squeeze(x), M.squeeze(x, 1),
                                           M.unsqueeze(x, [0, 4]),
                                           M.unsqueeze(x, -1)],
                          lambda r: [_u(r, 3, 1, 4, 1)], "f", True),
    "flatten": (lambda M, C, x: [M.flatten(x), M.flatten(x, 1, 2)],
                lambda r: [_u(r, 2, 3, 4)], "f", True),
    "cast": (lambda M, C, x: [M.cast(x, "int32"), M.cast(x, "float64")],
             lambda r: [_u(r, 3, 4) * 5], "f", False),
    "slice": (lambda M, C, x: [M.slice(x, [0, 1], [1, -3], [3, 10]),
                               M.strided_slice(x, [1], [0], [4], [2]),
                               M.strided_slice(x, [0, 1], [2, 3], [0, 0],
                                               [-1, -2])],
              lambda r: [_u(r, 3, 4)], "f", True),
    "gather": (lambda M, C, x, i: [M.gather(x, i), M.gather(x, i, 1)],
               lambda r: [_u(r, 3, 4), np.array([2, 0, 1], np.int64)], "f",
               True),
    "gather_nd": (lambda M, C, x, i: M.gather_nd(x, i),
                  lambda r: [_u(r, 3, 4, 2),
                             np.array([[0, 1], [2, 3], [1, 0]], np.int64)],
                  "f", True),
    "scatter": (lambda M, C, x, i, u: [M.scatter(x, i, u),
                                       M.scatter(x, i, u, False)],
                lambda r: [_u(r, 4, 3), np.array([2, 0], np.int64),
                           _u(r, 2, 3)], "f", True),
    "scatter_nd_add": (lambda M, C, x, i, u: M.scatter_nd_add(x, i, u),
                       lambda r: [_u(r, 3, 4),
                                  np.array([[0, 1], [2, 2], [0, 1]],
                                           np.int64), _u(r, 3)], "f", True),
    "expand": (lambda M, C, x, y: [M.expand(x, [2, 3, 4]),
                                   M.broadcast_to(x, [3, -1]),
                                   M.expand_as(x, y)],
               lambda r: [_u(r, 1, 4), _u(r, 3, 4)], "f", True),
    "tile": (lambda M, C, x: [M.tile(x, [2, 1]), M.tile(x, [2, 1, 3])],
             lambda r: [_u(r, 2, 3)], "f", True),
    "flip_reverse_roll": (lambda M, C, x: [M.flip(x, 1), M.flip(x, [0, 1]),
                                           M.reverse(x, 0),
                                           M.roll(x, 1), M.roll(x, [1, -1],
                                                                [0, 1])],
                          lambda r: [_u(r, 3, 4)], "f", True),
    "unique": (lambda M, C, x: list(M.unique(x, True, True, True)),
               lambda r: [np.array([[3, 1, 2], [3, 5, 1]], np.int64)], "i",
               False),
    "unique_float_nan": (lambda M, C, x: list(M.unique(x, True, True, True)),
                         lambda r: [np.array([2.0, NAN, 1.0, 2.0, NAN],
                                             F32)], "i", False),
    "index_select_sample": (lambda M, C, x, i, j: [M.index_select(x, i, 1),
                                                   M.index_sample(x, j)],
                            lambda r: [_u(r, 3, 4),
                                       np.array([3, 0, 3], np.int64),
                                       np.array([[0, 1], [3, 3], [2, 0]],
                                                np.int64)], "f", True),
    "masked_select": (lambda M, C, x, m: M.masked_select(x, m),
                      lambda r: [_u(r, 3, 4), r.rand(3, 4) > 0.5], "f",
                      True),
    "shard_index": (lambda M, C, x: M.shard_index(x, 20, 2, 1),
                    lambda r: [_i(r, 20, 6, 1)], "i", False),
    # -- creation ----------------------------------------------------------
    "full_zeros_ones": (lambda M, C: [M.full([2, 3], 1.5), M.zeros([2]),
                                      M.ones([2, 2], "int32"),
                                      M.empty([3], "float32")],
                        lambda r: [], "f", False),
    "like": (lambda M, C, x: [M.full_like(x, 2.0), M.zeros_like(x),
                              M.ones_like(x, "int64"), M.empty_like(x)],
             lambda r: [_u(r, 2, 3)], "f", False),
    "arange_linspace_eye": (lambda M, C: [M.arange(5), M.arange(1, 7, 2),
                                          M.arange(0.0, 1.0, 0.25,
                                                   "float32"),
                                          M.linspace(0, 1, 5),
                                          M.linspace(-2, 3, 4, "float64"),
                                          M.eye(3), M.eye(2, 4, "int32")],
                            lambda r: [], "t", False),
    "meshgrid": (lambda M, C, x, y: M.meshgrid(x, y),
                 lambda r: [_u(r, 3), _u(r, 4)], "f", True),
    "diag": (lambda M, C, x, m: [M.diag(x), M.diag(x, 1),
                                 M.diag(x, -1, 2.0), M.diag(m),
                                 M.diag(m, 1), M.diag_embed(m),
                                 M.diag_embed(x, 1)],
             lambda r: [_u(r, 3), _u(r, 3, 3)], "f", True),
    "tril_triu": (lambda M, C, x: [M.tril(x), M.tril(x, -1), M.triu(x),
                                   M.triu(x, 1)],
                  lambda r: [_u(r, 3, 4)], "f", True),
    "clone_assign": (lambda M, C, x: [M.clone(x), M.assign(x),
                                      M.assign(np.array([1.0, 2.0], F32))],
                     lambda r: [_u(r, 2, 3)], "f", True),
    "to_tensor": (lambda M, C: M.to_tensor(np.arange(6).reshape(2, 3)),
                  lambda r: [], "i", False),
    # -- logic -------------------------------------------------------------
    "compare": (lambda M, C, x, y: [M.equal(x, y), M.not_equal(x, y),
                                    M.less_than(x, y), M.less_equal(x, y),
                                    M.greater_than(x, y),
                                    M.greater_equal(x, y),
                                    M.equal(x, 1.0), M.equal_all(x, x),
                                    M.equal_all(x, y)],
                lambda r: [np.array([1.0, 2.0, 3.0, 1.0], F32),
                           np.array([1.0, 3.0, 2.0, 2.0], F32)], "i", False),
    "logical": (lambda M, C, a, b: [M.logical_and(a, b),
                                    M.logical_or(a, b),
                                    M.logical_xor(a, b),
                                    M.logical_not(a)],
                lambda r: [r.rand(3, 4) > 0.5, r.rand(3, 4) > 0.5], "i",
                False),
    "allclose": (lambda M, C, x, y: [M.allclose(x, y),
                                     M.allclose(x, y, atol=0.5),
                                     M.allclose(x, x)],
                 lambda r: [_u(r, 3), _u(r, 3)], "i", False),
    "is_empty_tensor": (lambda M, C, x: [M.is_empty(x),
                                         M.full([1], float(M.is_tensor(x)))],
                        lambda r: [_u(r, 2, 3)], "i", False),
    # -- search ------------------------------------------------------------
    "argmax_argmin": (lambda M, C, x: [M.argmax(x), M.argmax(x, 1),
                                       M.argmin(x, 0, True),
                                       M.argmin(x, dtype="int32")],
                      lambda r: [np.array([[1.0, 3.0, 3.0], [0.0, -1.0,
                                                             -1.0]], F32)],
                      "i", False),
    "argmax_nan": (lambda M, C, x: [M.argmax(x, 1), M.argmin(x, 1)],
                   lambda r: [TIES], "i", False),
    "argsort_sort": (lambda M, C, x: [M.argsort(x), M.argsort(x, 0, True),
                                      M.sort(x, 1, True), M.sort(x)],
                     lambda r: [_u(r, 3, 4)], "f", True),
    "argsort_ties_nan": (lambda M, C, x: [M.argsort(x), M.argsort(x, -1,
                                                                  True),
                                          M.sort(x), M.sort(x, 1, True)],
                         lambda r: [TIES], "i", False),
    "topk": (lambda M, C, x: [*M.topk(x, 2), *M.topk(x, 2, 0, False)],
             lambda r: [_u(r, 3, 4)], "f", True),
    "topk_ties_nan": (lambda M, C, x: [*M.topk(x, 5), *M.topk(x, 4, -1,
                                                              False)],
                      lambda r: [TIES], "i", False),
    "where_nonzero": (lambda M, C, c, x, y: [M.where(c, x, y),
                                             M.nonzero(c),
                                             *M.nonzero(c, True),
                                             M.where(c)],
                      lambda r: [r.rand(3, 4) > 0.5, _u(r, 3, 4),
                                 _u(r, 3, 4)], "f", True),
    # -- stat --------------------------------------------------------------
    "var_std": (lambda M, C, x: [M.var(x), M.var(x, 1, False, True),
                                 M.std(x), M.std(x, [0, 1])],
                lambda r: [_u(r, 3, 4)], "t", True),
    "numel_median": (lambda M, C, x: [M.numel(x), M.median(x),
                                      M.median(x, 1, True), M.median(x, 0)],
                     lambda r: [_u(r, 3, 4)], "f", False),
    # -- attribute ---------------------------------------------------------
    "attribute": (lambda M, C, x: [M.shape(x), M.rank(x), M.real(x),
                                   M.imag(x)],
                  lambda r: [_u(r, 2, 3)], "i", False),
}
CASES = {**MATH_CASES, **MANIP_CASES}

RANDOM = {
    "rand": (lambda M: M.rand([3, 4]), (0.0, 1.0)),
    "uniform": (lambda M: M.uniform([5], "float32", -2.0, 2.0), (-2.0, 2.0)),
    "randn": (lambda M: M.randn([3, 4]), None),
    "standard_normal": (lambda M: M.standard_normal([6]), None),
    "normal": (lambda M: M.normal(1.0, 2.0, [4, 2]), None),
    "normal_tensor": (lambda M: M.normal(M.zeros([2, 3]), 1.0), None),
    "randint": (lambda M: M.randint(2, 9, [4, 3]), (2, 8)),
    "randint_high": (lambda M: M.randint(5, shape=[7], dtype="int32"),
                     (0, 4)),
    "randperm": (lambda M: M.randperm(9), (0, 8)),
    "bernoulli": (lambda M: M.bernoulli(M.full([4, 5], 0.5)), (0.0, 1.0)),
    "multinomial": (lambda M: M.multinomial(M.full([2, 4], 0.25), 3, True),
                    (0, 3)),
}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else np.asarray(t)


def _flat(o):
    if isinstance(o, (list, tuple)):
        return [x for v in o for x in _flat(v)]
    return [o]


def _inputs(name):
    fn, make, kind, grad = CASES[name]
    r = np.random.RandomState(zlib.crc32(name.encode()))
    return fn, make(r), kind, grad


def _same(name, got, want, kind):
    got, want = [_np(g) for g in got], [_np(w) for w in want]
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        if kind == "i" or w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{name}[{i}]")
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), **TOL[kind],
                                       err_msg=f"{name}[{i}]")


def check_case(name):
    """Run CASES[name] in both packages; outputs, then gradients."""
    fn, arrays, kind, grad = _inputs(name)
    jins = [paddle_tpu.to_tensor(a, stop_gradient=not (
        grad and a.dtype == F32)) for a in arrays]
    tins = [pt.to_tensor(a, stop_gradient=not (grad and a.dtype == F32))
            for a in arrays]
    jout = _flat(fn(J, JC, *jins))
    tout = _flat(fn(T, TC, *tins))
    _same(name, tout, jout, kind)
    if not grad:
        return
    r = np.random.RandomState(1)
    jl = tl = None
    for jo, to in zip(jout, tout):
        if not np.issubdtype(_np(jo).dtype, np.floating):
            continue
        w = r.uniform(0.5, 1.5, _np(jo).shape).astype(_np(jo).dtype)
        jt = J.sum(J.multiply(jo, paddle_tpu.to_tensor(w)))
        tt = (to * torch.from_numpy(w)).sum()
        jl = jt if jl is None else J.add(jl, jt)
        tl = tt if tl is None else tl + tt
    jl.backward()
    tl.backward()
    for i, (ji, ti) in enumerate(zip(jins, tins)):
        if ti.requires_grad and ti.grad is None:
            # an input read for its shape only (expand_as's Y)
            assert ji.grad is None or not np.asarray(ji.grad).any(), i
        elif ti.requires_grad:
            np.testing.assert_allclose(
                ti.grad.numpy(), np.asarray(ji.grad), **GRAD_TOL,
                err_msg=f"{name} grad of input {i}")


def check_random(name):
    """RANDOM[name] in both packages: shapes, dtypes, ranges."""
    fn, rng = RANDOM[name]
    paddle_tpu.seed(3)
    pt.seed(3)
    j, t = _np(fn(J)), _np(fn(T))
    assert t.shape == j.shape, name
    assert t.dtype.kind == j.dtype.kind, (name, t.dtype, j.dtype)
    if rng is not None:
        assert t.min() >= rng[0] and t.max() <= rng[1], name
    # each eager call takes a new uid: a second call draws anew
    assert not np.array_equal(_np(fn(T)), t), name
