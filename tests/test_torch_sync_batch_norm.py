"""sync_batch_norm over 2 gloo ranks on the CPU
(tests/torch_dist_worker.py::sync_bn), each rank holding half of a
global batch, against one process's batch norm over the whole batch:

  (a) the sync_batch_norm kernel and its grad op: each rank's Y, saved
      statistics and X@GRAD equal the global batch_norm's (its rows),
      the running stats bitwise equal across ranks and within 1e-5 of
      the global ones, the ranks' Scale@GRAD / Bias@GRAD summing to the
      global ones;
  (b) the dygraph SyncBatchNorm layer: Y, X's gradient, the running stats;
  (c) a static program (conv2d -> batch_norm -> mean(y * ct), SGD) under
      `CompiledProgram` with `BuildStrategy.sync_batch_norm`: the pass
      rewrote batch_norm and batch_norm_grad in lockstep, and after one
      step Y, every parameter and the running stats equal one process's
      plain program over the global batch (1e-5; the ranks bitwise).

The pass itself is held against the JAX package's on one program: the
rewritten programs serialize equal.  Off a process group the op is the
local batch norm (test_torch_pool_norm_ops.py)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.pass_framework import apply_passes as japply
from paddle_tpu.core.program import _reset_unique_names as jreset
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.pass_framework import apply_passes as tapply
from paddle_tpu_torch.core.program import _reset_unique_names as treset
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops.registry import OpContext, run_kernel

import torch_dist_worker
from torch_dist_worker import build_bn_program

W = 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _data():
    r = np.random.RandomState(0)
    return {"x": r.randn(4, 3, 5, 5).astype(np.float32) + 1.0,
            "ct": r.randn(4, 3, 5, 5).astype(np.float32),
            "ct4": r.randn(4, 4, 5, 5).astype(np.float32),
            "scale": r.randn(3).astype(np.float32),
            "bias": r.randn(3).astype(np.float32),
            "mean": r.randn(3).astype(np.float32),
            "var": np.abs(r.randn(3)).astype(np.float32) + 0.5}


def _init_weights():
    """The static program's startup values (the JAX package's builder
    names; any values will do: both sides load the same ones)."""
    treset()
    main, startup, _, _ = build_bn_program(paddle_tpu_torch, (4, 3, 5, 5))
    exe = tstatic.Executor(tstatic.CPUPlace())
    scope = tstatic.Scope()
    with tstatic.scope_guard(scope):
        exe.run(startup)
    return {n: v.numpy() for n, v in scope.vars.items() if v is not None}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sync_bn")
    data = _data()
    init = _init_weights()
    np.savez(d / "in.npz", **data, **{"init/" + k: v
                                      for k, v in init.items()})
    tdist.spawn(torch_dist_worker.sync_bn,
                args=(str(d / "rendezvous"), str(d), str(d / "in.npz")),
                nprocs=W)
    return data, init, [dict(np.load(d / f"rank{r}.npz")) for r in range(W)]


def _bn(data):
    ins = {"X": torch.from_numpy(data["x"]),
           "Scale": torch.from_numpy(data["scale"]),
           "Bias": torch.from_numpy(data["bias"]),
           "Mean": torch.from_numpy(data["mean"]),
           "Variance": torch.from_numpy(data["var"])}
    attrs = {"momentum": 0.8, "epsilon": 1e-5}
    fwd = run_kernel("batch_norm", ins, attrs, OpContext())
    g = run_kernel("batch_norm_grad",
                   dict(ins, **fwd, **{"Y@GRAD": torch.from_numpy(
                       data["ct"])}), attrs, OpContext())
    return {k: v.detach().numpy() for k, v in list(fwd.items()) +
            list(g.items()) if v is not None}


def _rows(a, r):
    n = a.shape[0] // W
    return a[r * n:(r + 1) * n]


def test_kernel_and_grad_equal_the_global_batch_norm(world):
    data, _, ranks = world
    ref = _bn(data)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["a/Y"], _rows(ref["Y"], r), **TOL)
        np.testing.assert_allclose(got["a/X@GRAD"], _rows(ref["X@GRAD"], r),
                                   **TOL)
        for k in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
            np.testing.assert_allclose(got["a/" + k], ref[k], **TOL)
    for k in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        np.testing.assert_array_equal(ranks[0]["a/" + k], ranks[1]["a/" + k])
    for k in ("Scale@GRAD", "Bias@GRAD"):
        np.testing.assert_allclose(ranks[0]["a/" + k] + ranks[1]["a/" + k],
                                   ref[k], **TOL)


def test_dygraph_sync_batch_norm_equals_the_global_batch_norm(world):
    data, _, ranks = world
    ref = _bn(data)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["b/Y"], _rows(ref["Y"], r), **TOL)
        np.testing.assert_allclose(got["b/X@GRAD"], _rows(ref["X@GRAD"], r),
                                   **TOL)
        np.testing.assert_allclose(got["b/mean"], ref["MeanOut"], **TOL)
        np.testing.assert_allclose(got["b/var"], ref["VarianceOut"], **TOL)
    np.testing.assert_array_equal(ranks[0]["b/mean"], ranks[1]["b/mean"])
    np.testing.assert_allclose(ranks[0]["b/Scale@GRAD"]
                               + ranks[1]["b/Scale@GRAD"],
                               ref["Scale@GRAD"], **TOL)


def test_build_strategy_sync_batch_norm_equals_one_process(world):
    data, init, ranks = world
    treset()
    main, _, _, yv = build_bn_program(paddle_tpu_torch, data["x"].shape)
    scope = tstatic.Scope()
    load_params_from_numpy(scope, init, tstatic.CPUPlace())
    exe = tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(scope):
        (y,) = exe.run(main, feed={"x": data["x"], "ct": data["ct4"]},
                       fetch_list=[yv])
    for got in ranks:
        ops = list(got["c/ops"])
        assert "sync_batch_norm" in ops and "sync_batch_norm_grad" in ops
        assert "batch_norm" not in ops and "batch_norm_grad" not in ops
        np.testing.assert_allclose(got["c/Y"], y, **TOL)
        for n in init:
            if n.startswith("learning_rate"):
                continue
            np.testing.assert_allclose(got["c/var/" + n],
                                       scope.vars[n].numpy(), **TOL,
                                       err_msg=n)
    for n in init:
        np.testing.assert_array_equal(ranks[0]["c/var/" + n],
                                      ranks[1]["c/var/" + n])


def test_pass_rewrites_as_the_jax_package():
    """sync_batch_norm_pass on the same program in both packages: the
    training batch_norm and its grad op renamed with ring_id 0, the
    programs serializing equal."""
    jreset()
    jmain = build_bn_program(paddle_tpu, (4, 3, 5, 5))[0]
    treset()
    tmain = build_bn_program(paddle_tpu_torch, (4, 3, 5, 5))[0]
    assert tmain.to_dict() == jmain.to_dict()
    from paddle_tpu.core.pass_framework import PassContext as JCtx
    from paddle_tpu_torch.core.pass_framework import PassContext as TCtx
    jctx, tctx = JCtx(), TCtx()
    japply(jmain, ["sync_batch_norm_pass"], jctx)
    tapply(tmain, ["sync_batch_norm_pass"], tctx)
    assert tmain.to_dict() == jmain.to_dict()
    assert tctx.stats == jctx.stats == {"sync_batch_norm_pass": 1}
    types = [op.type for op in tmain.global_block().ops]
    assert "sync_batch_norm_grad" in types and "batch_norm" not in types
