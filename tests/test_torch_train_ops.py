"""Op-level parity for every op type of the training slice: the port's
registered kernel and its auto-derived `<type>_grad` kernel (torch.func.vjp
of the forward) against the JAX package's (jax.vjp, under jit as its
executor runs them; Pallas kernels in interpret mode).  Inputs and
cotangents come from a seeded numpy RNG and go to both packages.

Tolerance: atol=rtol=1e-5 in fp32 (the same formulas; reductions sum in
another order), outputs compared in float32 with equal dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static  # noqa: F401  (registers the JAX kernels)
import paddle_tpu_torch.static  # noqa: F401  (registers the port's kernels)
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.ops import registry as treg
from test_torch_train_program import fused_mode

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape, dtype="float32"):
    if dtype == "int64":
        return rng.randint(0, 10, shape).astype(np.int64)
    return np.asarray(rng.randn(*shape), dtype)


def _to_jax(x):
    if isinstance(x, list):
        return [_to_jax(i) for i in x]
    if isinstance(x, tuple):  # (array, "bfloat16")
        return jnp.asarray(x[0], jnp.bfloat16)
    return jnp.asarray(x)


def _to_torch(x):
    if isinstance(x, list):
        return [_to_torch(i) for i in x]
    if isinstance(x, tuple):
        return torch.from_numpy(x[0]).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))  # a writable copy, 0-d kept


def _run_jax(op_type, ins, attrs):
    kernel = jreg.get_op_info(op_type).kernel
    ctx = jreg.OpContext()
    out = jax.jit(lambda i: kernel(i, attrs, ctx))(
        {k: _to_jax(v) for k, v in ins.items()})
    return jax.tree_util.tree_map(np.asarray, out)


def _run_torch(op_type, ins, attrs):
    out = treg.get_op_info(op_type).kernel(
        {k: _to_torch(v) for k, v in ins.items()}, attrs,
        treg.OpContext())
    return {k: v for k, v in out.items() if v is not None}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x, np.float32) if np.issubdtype(
        x.dtype, np.floating) or x.dtype.name == "bfloat16" else x


def _compare(ref, got, keys, what):
    for k in keys:
        r, g = ref[k], got[k]
        rs = r if isinstance(r, list) else [r]
        gs = g if isinstance(g, list) else [g]
        assert len(rs) == len(gs), (what, k)
        for i, (a, b) in enumerate(zip(rs, gs)):
            assert dtype_name(b.dtype) == np.dtype(a.dtype).name, \
                (what, k, i, b.dtype, a.dtype)
            assert tuple(b.shape) == tuple(a.shape), (what, k, i)
            np.testing.assert_allclose(_f32(b), _f32(a),
                                       err_msg=f"{what} {k}[{i}]", **TOL)


# op type, inputs (numpy; a (array, "bfloat16") tuple is a bf16 input),
# attrs, output slots that receive a cotangent (None: no grad op)
_R = np.random.RandomState(0)
CASES = [
    ("lookup_table_v2", {"W": _rand(_R, (10, 8)),
                         "Ids": _rand(_R, (2, 5), "int64")},
     {"padding_idx": -1}, ["Out"]),
    ("layer_norm", {"X": _rand(_R, (2, 5, 8)), "Scale": _rand(_R, (8,)),
                    "Bias": _rand(_R, (8,))},
     {"begin_norm_axis": 2, "epsilon": 1e-5}, ["Y"]),
    ("mul", {"X": _rand(_R, (2, 5, 8)), "Y": _rand(_R, (8, 6))},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["Out"]),
    ("gelu", {"X": _rand(_R, (4, 8))}, {}, ["Out"]),
    ("reshape2", {"X": _rand(_R, (2, 5, 8))}, {"shape": [2, 5, 2, 4]},
     ["Out"]),
    ("transpose2", {"X": _rand(_R, (2, 5, 2, 4))}, {"axis": [0, 2, 1, 3]},
     ["Out"]),
    ("elementwise_add", {"X": _rand(_R, (2, 5, 6)), "Y": _rand(_R, (6,))},
     {"axis": 2}, ["Out"]),
    ("elementwise_mul", {"X": np.asarray(1.7, np.float32),
                         "Y": _rand(_R, (1,))}, {"axis": -1}, ["Out"]),
    ("mean", {"X": _rand(_R, (2, 5, 1))}, {}, ["Out"]),
    ("sum", {"X": [_rand(_R, (4, 3)) for _ in range(3)]}, {}, ["Out"]),
    ("cast", {"X": _rand(_R, (4, 3))},
     {"in_dtype": "float32", "out_dtype": "bfloat16"}, ["Out"]),
    ("cast", {"X": (_rand(_R, (4, 3)), "bfloat16")},
     {"in_dtype": "bfloat16", "out_dtype": "float32"}, ["Out"]),
    ("softmax_with_cross_entropy",
     {"Logits": _rand(_R, (2, 4, 30)),
      "Label": _R.randint(0, 30, (2, 4, 1)).astype(np.int64)},
     {"soft_label": False, "ignore_index": -100, "axis": -1}, ["Loss"]),
    ("flash_attention", {"Q": _rand(_R, (1, 2, 64, 32)),
                         "K": _rand(_R, (1, 2, 64, 32)),
                         "V": _rand(_R, (1, 2, 64, 32))},
     {"causal": False}, ["Out"]),
    ("adam", {"Param": _rand(_R, (4, 3)), "Grad": _rand(_R, (4, 3)),
              "LearningRate": np.asarray([1e-3], np.float32),
              "Moment1": _rand(_R, (4, 3)),
              "Moment2": np.abs(_rand(_R, (4, 3))),
              "Beta1Pow": np.asarray([0.9 ** 3], np.float32),
              "Beta2Pow": np.asarray([0.999 ** 3], np.float32)},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, None),
    ("check_finite_and_unscale",
     {"X": [_rand(_R, (4, 3)), _rand(_R, (5,))],
      "Scale": np.asarray([4.0], np.float32)}, {}, None),
    ("check_finite_and_unscale",
     {"X": [_rand(_R, (4, 3)), np.asarray([1.0, np.inf], np.float32)],
      "Scale": np.asarray([2.0], np.float32)}, {}, None),
    ("update_loss_scaling",
     {"X": [_rand(_R, (4, 3))], "FoundInfinite": np.asarray([True]),
      "PrevLossScaling": np.asarray([8.0], np.float32),
      "InGoodSteps": np.asarray([3], np.int32),
      "InBadSteps": np.asarray([1], np.int32)},
     {"incr_every_n_steps": 4, "decr_every_n_nan_or_inf": 2,
      "incr_ratio": 2.0, "decr_ratio": 0.5}, None),
    # the score-matrix attention of the flash-off program (the fp32 check
    # step's reference): q k^T scaled, softmax, probs v
    ("matmul", {"X": _rand(_R, (2, 2, 5, 4)), "Y": _rand(_R, (2, 2, 6, 4))},
     {"transpose_X": False, "transpose_Y": True, "alpha": 0.5}, ["Out"]),
    ("matmul", {"X": _rand(_R, (2, 2, 5, 6)), "Y": _rand(_R, (2, 2, 6, 4))},
     {}, ["Out"]),
    ("matmul", {"X": _rand(_R, (4, 5)), "Y": _rand(_R, (3, 4))},
     {"transpose_X": True, "transpose_Y": True}, ["Out"]),
    ("scale", {"X": _rand(_R, (2, 5, 8))},
     {"scale": 0.125, "bias": 0.5, "bias_after_scale": True}, ["Out"]),
    ("scale", {"X": _rand(_R, (2, 5, 8))},
     {"scale": 2.0, "bias": 1.0, "bias_after_scale": False}, ["Out"]),
    ("softmax", {"X": _rand(_R, (2, 2, 5, 6))}, {"axis": -1}, ["Out"]),
    ("softmax", {"X": (_rand(_R, (2, 5, 6)), "bfloat16")}, {"axis": 1},
     ["Out"]),
]


# every case with FLAGS_fused_xent off, and the op it changes with it on
PARAMS = [(i, False) for i in range(len(CASES))] + [
    (i, True) for i, c in enumerate(CASES)
    if c[0] == "softmax_with_cross_entropy"]


@pytest.mark.parametrize(
    "case,fused", PARAMS,
    ids=[f"{CASES[i][0]}-{i}" + ("-fused" if f else "") for i, f in PARAMS])
def test_op_and_grad_parity(case, fused):
    op_type, ins, attrs, ct_slots = CASES[case]
    with fused_mode(fused):
        ref = _run_jax(op_type, ins, attrs)
        got = _run_torch(op_type, ins, attrs)
        keys = [k for k in ref if k != "Softmax" or not fused]
        _compare(ref, got, keys, op_type)
        if ct_slots is None:
            assert not treg.get_op_info(op_type).has_grad
            return
        rng = np.random.RandomState(1)
        gins = dict(ins)
        gins.update({k: (v if v.dtype.name != "bfloat16"
                         else (v.astype(np.float32), "bfloat16"))
                     for k, v in ref.items()})
        for slot in ct_slots:
            r = ref[slot]
            ct = _rand(rng, r.shape)
            gins[slot + "@GRAD"] = ct if r.dtype.name != "bfloat16" \
                else (ct, "bfloat16")
        gref = _run_jax(op_type + "_grad", gins, attrs)
        ggot = _run_torch(op_type + "_grad", gins, attrs)
        assert set(ggot) == set(gref), (op_type, set(ggot), set(gref))
        _compare(gref, ggot, list(gref), op_type + "_grad")


def test_grad_op_slots_follow_the_reference_convention():
    for t in ("mul", "layer_norm", "flash_attention",
              "softmax_with_cross_entropy", "sum", "matmul", "scale",
              "softmax"):
        j, p = jreg.get_op_info(t + "_grad"), treg.get_op_info(t + "_grad")
        assert [s.name for s in p.inputs] == [s.name for s in j.inputs]
        assert [s.name for s in p.outputs] == [s.name for s in j.outputs]
        assert treg.get_op_info(t + "_grad_grad") is not None
        assert treg.get_op_info(t + "_grad_grad_grad") is None
    for t in ("adam", "check_finite_and_unscale", "fill_constant"):
        assert not treg.get_op_info(t).has_grad
