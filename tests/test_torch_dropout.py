"""The dropout op of the port on the CPU: the plain Philox generator
(`ops/dropout.py`, the bits the CUDA kernel of csrc/dropout_philox.cu
draws), the keying of a draw by (step seed, `fix_seed` seed or `Seed`
input, op uid), both of Paddle's dropout implementations against the JAX
package's kernel formula, and the explicit gradient from the saved Mask
against the JAX package's vjp gradient given the same mask.

Tolerances: the generator is integer arithmetic, held bit for bit against
a scalar Python Philox-4x32-10 and against the known-answer vectors of
Random123 (Salmon et al., SC'11).  The keep rate over 2^20 draws is
within +-0.003 of 1 - p (the binomial standard deviation is 0.0003-0.0005
there, so that is six or more of them).  Out against the formula: equal
to the last bit in fp32, bf16 and fp16.  The gradient against the JAX
package's, which runs under jit: one ulp of the dtype (rtol 1e-6 fp32,
2^-7 bf16, 2^-10 fp16), because XLA may fold the division by the
constant q into a multiply by its reciprocal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static  # noqa: F401  (registers the JAX kernels)
import paddle_tpu_torch.static  # noqa: F401  (registers the port's kernels)
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import dropout as tdrop
from paddle_tpu_torch.ops import registry as treg

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
# Random123's kat_vectors for philox4x32-10: (counter, key, output)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((MASK32,) * 4, (MASK32, MASK32),
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
ULP = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}


def scalar_philox(ctr, key):
    """Philox-4x32-10 on Python integers, one round at a time."""
    c, k = list(ctr), list(key)
    for i in range(10):
        if i:
            k = [(k[0] + W0) & MASK32, (k[1] + W1) & MASK32]
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK32,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & MASK32]
    return tuple(c)


def _philox_tensor(ctr, key):
    words = tdrop.philox4x32(*[torch.tensor(list(w), dtype=torch.int64)
                               for w in zip(*ctr)],
                             *[torch.tensor(list(w), dtype=torch.int64)
                               for w in zip(*key)])
    return [tuple(int(w[i]) for w in words) for i in range(len(ctr))]


def test_plain_philox_matches_scalar_reference_bit_for_bit():
    for ctr, key, want in KAT:
        assert scalar_philox(ctr, key) == want
    rng = np.random.RandomState(0)
    ctr = [tuple(int(v) for v in rng.randint(0, 2 ** 32, 4, np.uint64))
           for _ in range(256)] + [c for c, _, _ in KAT]
    key = [tuple(int(v) for v in rng.randint(0, 2 ** 32, 2, np.uint64))
           for _ in range(256)] + [k for _, k, _ in KAT]
    assert _philox_tensor(ctr, key) == [scalar_philox(c, k)
                                        for c, k in zip(ctr, key)]
    # the element layout: element e takes word e % 4 of group e // 4
    seed, uid, n = 0x1234_5678_9, 77, 41
    draws = tdrop.philox_draws(n, seed, uid).tolist()
    want = [scalar_philox((e // 4, 0, 0, 0),
                          (seed & MASK32, uid))[e % 4] for e in range(n)]
    assert draws == want
    # a seed tensor gives the bits of the same integer
    assert torch.equal(tdrop.philox_draws(n, torch.tensor([seed]), uid),
                       torch.tensor(want))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate(p):
    _, mask = tdrop.dropout_plain(torch.ones(1024, 1024), p, 2024, 3, True)
    rate = mask.double().mean().item()
    assert abs(rate - (1 - p)) <= 0.003
    assert tdrop.keep_threshold(0.0) == 2 ** 32
    assert tdrop.keep_threshold(1.0) == 0


def _port_op(x, attrs, seed=0, seed_input=None, is_test=False):
    ins = {"X": x, "Seed": seed_input}
    return treg.get_op_info("dropout").kernel(
        ins, attrs, treg.OpContext(seed=seed, is_test=is_test))


def _attrs(p=0.5, uid=11, impl="upscale_in_train", seed=None):
    return {"dropout_prob": p, "is_test": False, "seed": seed or 0,
            "fix_seed": seed is not None, "op_uid": uid,
            "dropout_implementation": impl}


def test_masks_differ_by_uid_step_seed_and_element():
    x = torch.ones(16, 64)
    base = _port_op(x, _attrs(uid=11), seed=5)["Mask"]
    assert not torch.equal(base, _port_op(x, _attrs(uid=12), seed=5)["Mask"])
    assert not torch.equal(base, _port_op(x, _attrs(uid=11), seed=6)["Mask"])
    assert torch.equal(base, _port_op(x, _attrs(uid=11), seed=5)["Mask"])
    # every element of a row draws its own 32-bit word
    draws = tdrop.philox_draws(16 * 64, 5, 11).reshape(16, 64)
    for row in draws:
        assert len(set(row.tolist())) == 64
    # the grad op's fwd_uid keys the draw like the forward's op_uid
    fwd = dict(_attrs(uid=11), op_uid=99, fwd_uid=11)
    assert torch.equal(base, _port_op(x, fwd, seed=5)["Mask"])


def test_fix_seed_gives_the_same_mask_every_step():
    x = torch.ones(8, 32)
    masks = [_port_op(x, _attrs(seed=42), seed=s)["Mask"] for s in (1, 2, 3)]
    assert all(torch.equal(masks[0], m) for m in masks[1:])
    assert torch.equal(masks[0], tdrop.dropout_plain(x, 0.5, 42, 11,
                                                     True)[1])
    assert not torch.equal(masks[0], _port_op(x, _attrs(), seed=1)["Mask"])


@pytest.mark.parametrize("seed_dtype", [torch.int64, torch.int32])
def test_seed_input_overrides_step_and_attr_seed(seed_dtype):
    x = torch.ones(8, 32)
    seeded = _port_op(x, _attrs(seed=42), seed=1,
                      seed_input=torch.tensor([9], dtype=seed_dtype))
    assert torch.equal(seeded["Mask"],
                       _port_op(x, _attrs(seed=9), seed=1)["Mask"])
    assert torch.equal(seeded["Mask"], _port_op(x, _attrs(), seed=9)["Mask"])


def _formula(x, mask, p, impl, is_test):
    """The JAX package's kernel (paddle_tpu/ops/kernels/nn.py:481-496) given
    its keep mask, in numpy over X's dtype."""
    dt = x.dtype
    if is_test:
        q = np.float32(np.asarray(1 - p, dt))
        return x if impl == "upscale_in_train" else \
            (x.astype(np.float32) * q).astype(dt)
    keep = mask.astype(bool)
    if impl == "upscale_in_train":
        q = np.float32(np.asarray(max(1.0 - p, 1e-8), dt))
        return np.where(keep, (x.astype(np.float32) / q).astype(dt),
                        np.zeros((), dt))
    return np.where(keep, x, np.zeros((), dt))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_implementations_follow_the_reference_formula(dtype, impl, is_test):
    rng = np.random.RandomState(1)
    x32 = rng.randn(6, 40).astype(np.float32)
    x = torch.from_numpy(x32).to(dtype)
    p = 0.3
    attrs = dict(_attrs(p=p, impl=impl), is_test=is_test)
    out = _port_op(x, attrs, seed=123)
    assert out["Out"].dtype == dtype and out["Mask"].dtype == torch.uint8
    mask = out["Mask"].numpy()
    if is_test:
        assert mask.all()
    else:
        assert 0 < mask.mean() < 1
    xd = _np(x).astype(np.float32)
    want = _formula(np.asarray(jnp.asarray(xd, JDT[dtype])), mask, p, impl,
                    is_test)
    np.testing.assert_array_equal(_np(out["Out"]),
                                  np.asarray(want, np.float32))
    # the JAX package's own kernel: its mask is threefry's, its formula the
    # same one
    ref = jreg.get_op_info("dropout").kernel(
        {"X": jnp.asarray(xd, JDT[dtype])}, attrs,
        jreg.OpContext(seed=jnp.uint32(123)))
    ref_want = _formula(np.asarray(jnp.asarray(xd, JDT[dtype])),
                        np.asarray(ref["Mask"]), p, impl, is_test)
    np.testing.assert_array_equal(np.asarray(ref["Out"], np.float32),
                                  np.asarray(ref_want, np.float32))
    if is_test:
        np.testing.assert_array_equal(np.asarray(ref["Out"], np.float32),
                                      _np(out["Out"]))


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grad_from_mask_matches_jax_vjp(dtype, impl, is_test):
    """The JAX package's dropout_grad (jax.vjp of its kernel, which redraws
    the forward's mask from the same key) against the port's explicit
    grad handed the JAX forward's Mask."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 48).astype(np.float32)
    g = rng.randn(4, 48).astype(np.float32)
    jdt = JDT[dtype]
    attrs = dict(_attrs(p=0.25, uid=5, impl=impl), is_test=is_test)
    ctx = jreg.OpContext(seed=jnp.uint32(31))
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    fwd = jax.jit(lambda a: jreg.get_op_info("dropout").kernel(
        {"X": a}, attrs, ctx))(jx)
    gattrs = dict(attrs, fwd_uid=5, op_uid=6)
    ref = jax.jit(lambda a, d: jreg.get_op_info("dropout_grad").kernel(
        {"X": a, "Seed": None, "Out": fwd["Out"], "Mask": fwd["Mask"],
         "Out@GRAD": d}, gattrs, ctx))(jx, jg)["X@GRAD"]
    got = treg.get_op_info("dropout_grad").kernel(
        {"X": torch.from_numpy(x).to(dtype), "Seed": None,
         "Out": None, "Mask": torch.from_numpy(np.array(fwd["Mask"])),
         "Out@GRAD": torch.from_numpy(g).to(dtype)},
        gattrs, treg.OpContext(seed=31, is_test=is_test))["X@GRAD"]
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               rtol=ULP[dtype], atol=0)


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    x = torch.randn(3, 5)
    out, mask = tdrop.dropout_fwd(x, 0.5, 7, 1, True)
    ref_out, ref_mask = tdrop.dropout_plain(x, 0.5, 7, 1, True)
    assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdrop.dropout_cuda(x, 0.5, 7, 1, True)
    meta_out, meta_mask = tdrop.dropout_fwd(x.to("meta"), 0.5, 7, 1, True)
    assert meta_out.shape == x.shape and meta_mask.dtype == torch.uint8
