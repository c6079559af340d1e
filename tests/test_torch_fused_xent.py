"""The port's fused softmax-cross-entropy on the CPU (`fused_xent_plain`,
the plain version of the Hopper kernel, and the torch backward) against
paddle_tpu's Pallas `fused_softmax_xent` run in interpret mode, as
tests/test_attention.py runs it.  Logits and labels come from a seeded
numpy RNG and go to both packages.

Tolerances: loss and lse atol=rtol=1e-5, gradient atol=1e-6 rtol=1e-5
(fp32, the same online max / sumexp in another summation order); bf16
logits atol=rtol=2e-2 (both sides read the same bf16 values and sum in
fp32; the JAX backward rounds dlogits to bf16); fp16 logits: loss and
lse at the fp32 tolerance, the fp16 gradient at atol=rtol=2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_xent as jfx
from paddle_tpu_torch.ops import fused_xent as tfx

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP16_TOL = dict(rtol=2e-3, atol=2e-3)


def _inputs(t, v, seed, ignore=None, every=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(t, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, (t,)).astype(np.int64)
    if every:
        labels[::every] = ignore
    dy = rng.randn(t).astype(np.float32)
    return logits, labels, dy


def _jax_ref(logits, labels, dy, ignore, dtype=jnp.float32):
    lg = jnp.asarray(logits, dtype)
    lb = jnp.asarray(labels.astype(np.int32))
    t = logits.shape[0]
    bt = 8 if t % 8 == 0 else t
    loss, lse = jfx._fused_xent_fwd(lg, lb, ignore, bt, 256, True)
    _, vjp = jax.vjp(lambda x: jfx.fused_softmax_xent(
        x, lb, ignore, bt, 256, True), lg)
    (grad,) = vjp(jnp.asarray(dy).reshape(t, 1))
    return (np.asarray(loss)[:, 0], np.asarray(lse)[:, 0],
            np.asarray(grad.astype(jnp.float32)))


def _port(logits, labels, dy, ignore, dtype=torch.float32):
    lg = torch.from_numpy(logits).to(dtype)
    lb = torch.from_numpy(labels)
    loss, lse = tfx.fused_xent_plain(lg, lb, ignore)
    _, vjp = torch.func.vjp(lambda x: tfx.fused_softmax_xent(x, lb, ignore),
                            lg)
    (grad,) = vjp(torch.from_numpy(dy))
    return loss.numpy(), lse.numpy(), grad.float().numpy()


@pytest.mark.parametrize("t,v", [(64, 777), (16, 4096), (24, 300)])
def test_fused_xent_matches_pallas(t, v):
    """Ragged vocab tails (777 and 300 are not multiples of the blocks)."""
    args = _inputs(t, v, seed=v)
    ref, got = _jax_ref(*args, -100), _port(*args, -100)
    for tag, r, g, tol in zip(("loss", "lse", "grad"), ref, got,
                              (LOSS_TOL, LOSS_TOL, GRAD_TOL)):
        np.testing.assert_allclose(g, r, err_msg=tag, **tol)


@pytest.mark.parametrize("ignore", [7, -1])
def test_fused_xent_ignore_index(ignore):
    """Positive and negative ignore_index: loss 0 and no gradient on those
    rows, lse still written."""
    args = _inputs(32, 500, seed=11, ignore=ignore, every=4)
    ref, got = _jax_ref(*args, ignore), _port(*args, ignore)
    for tag, r, g, tol in zip(("loss", "lse", "grad"), ref, got,
                              (LOSS_TOL, LOSS_TOL, GRAD_TOL)):
        np.testing.assert_allclose(g, r, err_msg=tag, **tol)
    assert np.all(got[0][::4] == 0) and np.all(got[2][::4] == 0)
    assert np.all(np.isfinite(got[1]))


def test_fused_xent_bf16_logits():
    args = _inputs(32, 1000, seed=3)
    ref = _jax_ref(*args, -100, dtype=jnp.bfloat16)
    got = _port(*args, -100, dtype=torch.bfloat16)
    for tag, r, g in zip(("loss", "lse", "grad"), ref, got):
        np.testing.assert_allclose(g, r, err_msg=tag, **BF16_TOL)


def test_fused_xent_fp16_logits():
    """fp16 logits: loss and lse against the Pallas kernel in interpret
    mode in fp16 at LOSS_TOL (both read the same fp16 values and keep
    fp32 statistics, so only the summation order differs); the gradient,
    rounded to fp16 on both sides, at FP16_TOL (fp16 ulp 2^-11)."""
    args = _inputs(32, 1000, seed=5)
    ref = _jax_ref(*args, -100, dtype=jnp.float16)
    got = _port(*args, -100, dtype=torch.float16)
    for tag, r, g, tol in zip(("loss", "lse", "grad"), ref, got,
                              (LOSS_TOL, LOSS_TOL, FP16_TOL)):
        np.testing.assert_allclose(g, r, err_msg=tag, **tol)


def test_out_of_range_label_picks_nothing():
    """The kernel's semantics for a label outside [0, V) that is not
    ignore_index: nothing is picked, so loss = lse."""
    logits, labels, _ = _inputs(8, 50, seed=1)
    labels[2], labels[5] = 50, -3
    loss, lse = tfx.fused_xent_plain(torch.from_numpy(logits),
                                     torch.from_numpy(labels), -100)
    assert loss[2] == lse[2] and loss[5] == lse[5]


def test_dispatch_conditions():
    """maybe_fused_xent: flag, hard labels and last axis; no sublane (lead
    % 8) condition and no traced-only condition in the port."""
    logits = torch.randn(3, 5, 40)
    label = torch.randint(0, 40, (3, 5, 1))
    tfx.enable_fused_xent(False)
    assert tfx.maybe_fused_xent(logits, label, 2, False, -100) is None
    tfx.enable_fused_xent(True)
    try:
        assert tfx.maybe_fused_xent(logits, label, 2, True, -100) is None
        assert tfx.maybe_fused_xent(logits, label, 1, False, -100) is None
        loss = tfx.maybe_fused_xent(logits, label, 2, False, -100)
    finally:
        tfx.enable_fused_xent(False)
    assert loss.shape == (3, 5, 1) and loss.dtype == torch.float32
    ref = torch.nn.functional.cross_entropy(
        logits.reshape(15, 40), label.reshape(15), reduction="none")
    torch.testing.assert_close(loss.reshape(15), ref, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    logits, label = torch.zeros(4, 10), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfx.fused_xent_cuda(logits, label)
