"""paddle_tpu_torch.tensor on graph vars (a 2.0 static program), held
against paddle_tpu.tensor on the CPU: each program below is built with
the same tensor functions in both packages (VarDesc inputs, or
`enable_static()` for the functions without a tensor input), and

  * the main and startup programs serialize equal (`to_dict`: op types,
    attrs, var names, shapes and dtypes; the data-dependent outputs of
    masked_select / where_index / unique unset in both);
  * their fetches through both Executors agree on the same numpy feeds
    (floats within 1e-5: the programs mix transcendental functions and
    products; integers and booleans by value);
    random ops draw other numbers (Philox against threefry), so there
    only shapes, dtypes and ranges are compared.

Also: every op type a `paddle_tpu.tensor` / `compat` function dispatches
is registered in the port, and a program holding a data-dependent op
runs its `run_steps` eagerly (no CUDA graph), each step's shape its own.
"""
import ast
import glob
import os

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.static as jstatic
import paddle_tpu.tensor as J
import paddle_tpu.tensor.compat as JC
from paddle_tpu.core.program import _reset_unique_names as jreset

import paddle_tpu_torch as pt
import paddle_tpu_torch.static as tstatic
import paddle_tpu_torch.tensor as T
import paddle_tpu_torch.tensor.compat as TC
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import _reset_unique_names as treset

F32 = np.float32
TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
    yield


def _data(S, feeds):
    return {n: S.data(n, list(a.shape), str(a.dtype)) for n, a in
            feeds.items()}


def p_math(M, C, S, d):
    x, y = d["x"], d["y"]
    return [M.add(x, y), M.multiply(x, 2.0), M.exp(x), M.sqrt(M.abs(x)),
            M.logsumexp(x, 1), M.cumsum(x, 0), M.clip(x, -0.2, 0.3),
            M.pow(x, 2), M.maximum(x, y), M.minimum(x, y),
            M.sum(x, 1, "float64"), M.prod(x, 0), M.max(x), M.min(x, 1, True),
            M.mean(x, [0, 1]), M.scale(x, 2.0, 1.0, act="tanh"),
            M.isfinite(x), M.floor(x), M.round(x), M.erf(x), M.sign(x),
            M.remainder(x, y), M.stanh(x), M.trace(M.matmul(x, x, False,
                                                            True)),
            M.kron(x, y), M.all(M.greater_than(x, y), 1),
            M.any(M.greater_than(x, y))]


def p_manip(M, C, S, d):
    x, i = d["x"], d["i"]
    u = M.unsqueeze(x, [0, 3])
    return [u, M.squeeze(u), M.squeeze(u, 0), M.stack([x, x], 1),
            *M.split(x, [1, 2], 1), *M.split(x, 2, 0), *M.unbind(x, 1),
            *M.unstack(x, 0), M.concat([x, x]), M.expand(
                M.unsqueeze(x, 0), [2, 4, 3]), M.tile(x, [2, 1]),
            M.flip(x, [0]), M.roll(x, 1, 0), M.reverse(x, 1),
            M.gather_nd(x, M.unsqueeze(i, 1)), M.gather(x, i),
            M.index_select(x, i, 0), M.scatter(x, i, M.gather(x, i)),
            M.transpose(x, [1, 0]), M.reshape(x, [3, 4]),
            M.flatten(M.unsqueeze(x, 0)), M.slice(x, [1], [1], [3]),
            M.strided_slice(x, [0], [0], [4], [2]), M.cast(i, "float32"),
            M.expand_as(M.unsqueeze(d["y"], 0), x),
            M.index_sample(x, d["j"]),
            M.shard_index(M.reshape(i, [4, 1]), 4, 2, 0)]


def p_search(M, C, S, d):
    x = d["x"]
    v, k = M.topk(x, 2)
    v2, k2 = M.topk(x, 3, 0, False)
    return [v, k, v2, k2, M.argsort(x, 1), M.argsort(x, 0, True),
            M.sort(x, 1, True), M.argmax(x, 1), M.argmin(x),
            M.where(M.greater_than(x, d["y"]), x, d["y"])]


def p_linalg(M, C, S, d):
    x, y = d["x"], d["y"]
    sq = M.matmul(x, x, True)
    return [M.mm(x, M.transpose(x, [1, 0])), M.bmm(M.unsqueeze(x, 0),
                                                   M.unsqueeze(sq, 0)),
            M.norm(x), M.norm(x, 2, 1), M.norm(x, "fro", [0, 1]),
            M.dist(x, M.scale(x, 0.5)), M.dot(x, x), M.mv(x, y),
            M.cross(sq, sq, 0), C.einsum("ij,j->i", x, y),
            M.histogram(x, 4, -1, 1), M.inverse(M.add(sq, M.eye(3)))]


def p_logic(M, C, S, d):
    x, y = d["x"], d["y"]
    a, b = M.greater_than(x, y), M.less_equal(x, y)
    return [M.equal(x, y), M.not_equal(x, y), M.less_than(x, y),
            M.greater_equal(x, y), M.logical_and(a, b), M.logical_or(a, b),
            M.logical_xor(a, b), M.logical_not(a), M.allclose(x, x),
            M.equal_all(x, x), M.is_empty(x), M.isnan(x), M.isinf(x),
            C.has_nan(x)]


def p_creation(M, C, S, d):
    x = d["x"]
    return [M.zeros([2, 3]), M.ones([3], "int32"), M.full([2], 7.0),
            M.arange(6), M.arange(1.0, 2.0, 0.25, "float32"),
            M.linspace(0, 1, 5), M.eye(3, 4), M.full_like(x, 2.0),
            M.zeros_like(x), M.ones_like(x, "int64"), M.empty([2]),
            M.empty_like(x), *M.meshgrid(M.arange(2), M.arange(3)),
            M.diag(M.linspace(1, 3, 3)), M.diag(x), M.diag_embed(x),
            M.tril(x), M.triu(x, 1), M.clone(x), M.assign(x),
            M.shape(x), M.rank(x), M.numel(x), M.real(x), M.imag(x),
            M.var(x, 1), M.std(x)]


def p_compat(M, C, S, d):
    x, y = d["x"], d["y"]
    w = C.create_parameter([3], "float32", is_bias=True)
    g = C.create_global_var([1], 2.0, "float32", persistable=True)
    return [C.elementwise_add(x, y), C.elementwise_mul(x, y, axis=1),
            C.elementwise_sub(x, y), C.elementwise_div(x, y),
            C.elementwise_max(x, y), C.elementwise_min(x, y),
            C.elementwise_pow(M.abs(x), y), C.elementwise_sum([x, x]),
            C.reduce_sum(x, 1), C.reduce_mean(x), C.reduce_max(x, 0, True),
            C.reduce_min(x), C.reduce_prod(x, 1),
            C.reduce_all(M.greater_than(x, y)), C.addcmul(x, x, x, 0.5),
            C.fill_constant([2], "float32", 1.5), C.crop_tensor(x, [2, 2],
                                                                [1, 1]),
            C.get_tensor_from_selected_rows(x), M.add(x, w),
            M.add(x, g), C.has_inf(x)]


def p_dynamic(M, C, S, d):
    x = d["x"]
    m = M.greater_than(x, d["y"])
    out, first, inv, cnt = M.unique(d["i"], True, True, True)
    return [M.masked_select(x, m), M.nonzero(m), out, first, inv, cnt]


def p_random(M, C, S, d):
    return [M.rand([3, 4]), M.uniform([2, 2], min=-3.0, max=3.0),
            M.randn([5]), M.normal(1.0, 2.0, [4]), M.randint(0, 7, [3, 2]),
            M.randperm(6), M.bernoulli(M.full_like(d["x"], 0.5)),
            M.multinomial(M.full([2, 5], 0.2), 4)]


PROGRAMS = {"math": p_math, "manip": p_manip, "search": p_search,
            "linalg": p_linalg, "logic": p_logic, "creation": p_creation,
            "compat": p_compat, "dynamic": p_dynamic, "random": p_random}
# the fetches of these compare shapes, dtypes and ranges only
DRAWS = {"random"}
# the JAX executor jits the program, which no data-dependent shape
# survives (paddle_tpu/ops/kernels/manip.py's note): these fetches are
# held against numpy
NUMPY = {"dynamic": lambda f: [
    f["x"][f["x"] > f["y"]], np.argwhere(f["x"] > f["y"]),
    *np.unique(f["i"], return_index=True, return_inverse=True,
               return_counts=True)]}


def _feeds(name):
    r = np.random.RandomState(len(name))
    return {"x": r.uniform(-1, 1, (4, 3)).astype(F32),
            "y": r.uniform(-1, 1, (3,)).astype(F32),
            "i": np.array([2, 0, 3, 1], np.int64),
            "j": np.array([[0], [2], [1], [2]], np.int64)}


def _build(pkg, S, M, C, reset, name):
    reset()
    feeds = _feeds(name)
    main, startup = S.Program(), S.Program()
    pkg.enable_static()
    try:
        with S.program_guard(main, startup):
            outs = PROGRAMS[name](M, C, S, _data(S, feeds))
    finally:
        pkg.disable_static()
    return main, startup, outs, feeds


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_static_program_serializes_and_runs_equal(name):
    jmain, jstart, jouts, feeds = _build(paddle_tpu, jstatic, J, JC, jreset,
                                         name)
    tmain, tstart, touts, _ = _build(pt, tstatic, T, TC, treset, name)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    names = [v.name for v in jouts]
    assert names == [v.name for v in touts]
    if name in NUMPY:
        jgot = NUMPY[name](feeds)
    else:
        jexe = jstatic.Executor()
        jexe.run(jstart)
        jgot = jexe.run(jmain, feed=feeds, fetch_list=names)
    texe = tstatic.Executor(CPUPlace())
    texe.run(tstart)
    tgot = texe.run(tmain, feed=feeds, fetch_list=names)
    for n, a, b in zip(names, tgot, jgot):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (n, a.shape, b.shape)
        if name in DRAWS:
            assert a.dtype.kind == b.dtype.kind, n
            continue
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=n)
        else:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), **TOL,
                                       err_msg=n)


def _dispatched_op_types():
    """Every op type the JAX package's tensor functions dispatch: the
    literal op names handed to dispatch / _binary / _reduce / _cmp /
    _ew_compat / _make_unary in paddle_tpu/tensor/*.py."""
    ops = set()
    calls = {"dispatch", "_binary", "_reduce", "_cmp", "_ew_compat"}
    for path in glob.glob(os.path.join(ROOT, "paddle_tpu", "tensor",
                                       "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) in calls and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                ops.add(node.args[0].value)
    from paddle_tpu.tensor.math import _UNARY
    return ops | set(_UNARY)


def test_every_dispatched_op_is_registered_in_the_port():
    import paddle_tpu_torch.ops.kernels  # noqa: F401 (registers)
    from paddle_tpu_torch.ops.registry import all_ops
    ops = _dispatched_op_types()
    assert len(ops) > 120
    missing = sorted(ops - set(all_ops()))
    assert not missing, missing
    # the random ops of paddle_tpu/ops/kernels/random.py too
    for op in ("truncated_gaussian_random", "sampling_id", "bernoulli",
               "randint", "randperm", "multinomial"):
        assert op in all_ops(), op


def test_data_dependent_program_runs_its_steps_eagerly():
    from paddle_tpu_torch.ops.kernels.distributed_ops import has_host_ops
    tmain, tstart, touts, _ = _build(pt, tstatic, T, TC, treset, "dynamic")
    assert has_host_ops(tmain)
    assert all(v.shape is None for v in touts)
    exe = tstatic.Executor(CPUPlace())
    exe.run(tstart)
    r = np.random.RandomState(5)
    k = 3
    # 6 positive elements a step, at other places (run_steps stacks the
    # fetches, so their shapes agree across steps)
    vals = np.array([1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1], F32)
    feed = {"x": np.stack([r.permutation(vals).reshape(4, 3)
                           for _ in range(k)]),
            "y": np.zeros((k, 3), F32),
            "i": np.stack([np.array([2, 0, 3, 1])] * k).astype(np.int64)}
    got = exe.run_steps(tmain, feed=feed, fetch_list=[touts[1].name])[0]
    for s in range(k):
        np.testing.assert_array_equal(_np(got[s]),
                                      np.argwhere(feed["x"][s] > 0))


def test_static_mode_switch():
    assert pt.in_dynamic_mode()
    pt.enable_static()
    try:
        assert not pt.in_dynamic_mode()
        # a creation function now builds an op in the current program
        main = tstatic.Program()
        with tstatic.program_guard(main, tstatic.Program()):
            v = T.zeros([2])
        assert [op.type for op in main.global_block().ops] == \
            ["fill_constant"]
        assert v.shape == (2,)
        # a torch tensor input still runs eagerly
        with pt.dygraph.guard(CPUPlace()):
            assert pt.in_dynamic_mode()
            out = T.add(torch.ones(2), torch.ones(2))
        assert torch.equal(out, torch.full((2,), 2.0))
    finally:
        pt.disable_static()
    assert pt.in_dynamic_mode()
