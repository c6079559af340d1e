"""Shared parity check for the convolution, pooling, norm and
interpolation ops (tests/test_torch_{conv,pool_norm,interp}_ops.py): the
port's kernel and grad op against the JAX package's under `jax.jit` on
the same numpy inputs and cotangents.  Not a test module.

Tolerances: fp32 atol = rtol = 1e-5 (the same formulas; cuDNN / ATen and
XLA sum in other orders); bf16 2e-2 forward and 5e-2 on the gradients
(8 bits of mantissa, summed in another order).  Index outputs (int64)
are compared by value."""
import numpy as np
import torch

import paddle_tpu.static  # noqa: F401  (registers the JAX kernels)
import paddle_tpu_torch.static  # noqa: F401  (registers the port's kernels)
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.ops import registry as treg
from test_torch_train_ops import _f32, _rand, _run_jax, _run_torch, _to_jax

R = np.random.RandomState(27)


def f(*shape):
    return _rand(R, shape)


def bf16(*shape):
    return (_rand(R, shape), "bfloat16")


def run_jax_eager(op_type, ins, attrs):
    """The JAX kernel outside jit: an op that reads a tensor's value at
    trace time (the OutSize / OutputShape inputs) runs so in the JAX
    package's eager mode."""
    import jax
    from paddle_tpu.ops import registry as jreg
    out = jreg.get_op_info(op_type).kernel(
        {k: _to_jax(v) for k, v in ins.items()}, attrs, jreg.OpContext())
    return jax.tree_util.tree_map(np.asarray, out)


def _is_low(ins):
    return any(isinstance(v, tuple) for v in ins.values())


def compare(ref, got, keys, what, tol, dtype=True):
    for k in keys:
        r, g = ref[k], got[k]
        if dtype:
            assert dtype_name(g.dtype) == np.dtype(r.dtype).name, \
                (what, k, g.dtype, r.dtype)
        assert tuple(g.shape) == tuple(r.shape), (what, k, g.shape, r.shape)
        np.testing.assert_allclose(_f32(g), _f32(r), err_msg=f"{what} {k}",
                                   rtol=tol, atol=tol)


def check_case(op_type, ins, attrs, ct_slots, skip=(), dtype=True,
               zero=(), jit=True):
    """Forward of every output slot, then (with `ct_slots`) the grad op
    fed the same cotangents on those slots, every gradient slot but
    `skip` held to the JAX vjp's; each is nonzero but those of `zero`
    (a slot whose gradient is 0 in exact arithmetic)."""
    low = _is_low(ins)
    run_jax = _run_jax if jit else run_jax_eager
    ref = run_jax(op_type, ins, attrs)
    got = _run_torch(op_type, ins, attrs)
    assert set(got) == set(ref), (set(got), set(ref))
    compare(ref, got, list(ref), op_type, 2e-2 if low else 1e-5, dtype)
    if ct_slots is None:
        return ref, got
    rng = np.random.RandomState(1)
    gins = dict(ins)
    gins.update({k: (v if v.dtype.name != "bfloat16"
                     else (v.astype(np.float32), "bfloat16"))
                 for k, v in ref.items()})
    for slot in ct_slots:
        ct = _rand(rng, ref[slot].shape)
        if ref[slot].dtype == np.float64:
            ct = ct.astype(np.float64)
        gins[slot + "@GRAD"] = ct if ref[slot].dtype.name != "bfloat16" \
            else (ct, "bfloat16")
    gref = run_jax(op_type + "_grad", gins, attrs)
    ggot = _run_torch(op_type + "_grad", gins, attrs)
    want = set(gref) - set(skip)
    assert want <= set(ggot), (set(ggot), set(gref))
    assert all(np.abs(_f32(gref[k])).max() > 0 for k in want - set(zero))
    compare(gref, ggot, sorted(want), op_type + "_grad",
            5e-2 if low else 1e-5, dtype)
    return ref, got


def grad_slots_match(op_type):
    """The grad op's slots follow the JAX package's convention."""
    from paddle_tpu.ops import registry as jreg
    j, p = jreg.get_op_info(op_type + "_grad"), \
        treg.get_op_info(op_type + "_grad")
    assert [s.name for s in p.inputs] == [s.name for s in j.inputs]
    assert [s.name for s in p.outputs] == [s.name for s in j.outputs]


def torch_tensor(x):
    return torch.from_numpy(np.array(x))
