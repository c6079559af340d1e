"""Switch Mixture-of-Experts in the port (incubate/moe.py, the switch_moe
op, static.layers.switch_moe, nn.SwitchMoE) against the JAX package on
the CPU.

  * `switch_moe` and `moe_aux_loss` on the JAX package's weights: the
    output and the aux loss within 1e-6, the gradients of
    mean((out - y) ** 2) + 0.01 aux within 1e-5 (tests/test_moe.py:32's
    loss), the capacity drops equal; `init_moe_params` draws the JAX
    shapes from a torch.Generator;
  * expert parallelism on 4 gloo ranks (ep 4, one expert a rank, tokens
    sharded as tests/test_moe.py:56 does): the output within 2e-5 of the
    JAX dense and ep-sharded runs, the gradients (experts' / world,
    the gate's averaged, the tokens') within 5e-4 of the dense ones, 2
    all-to-alls forward and 2 backward; the op with `ep_ring_id` bound
    agrees;
  * the op, the static layer and nn.SwitchMoE (tests/test_moe.py:128,
    145, 180): the op equals the JAX op, the static block serializes
    equal to the JAX package's and trains 5 Adam steps as the JAX
    executor does (losses within rtol 1e-5), and the dygraph block's
    gradients reach the gate and every expert.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu
import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu.ops.registry import OpContext as JCtx, run_kernel as jrun
from paddle_tpu.utils.shard_map_compat import shard_map_unchecked

import paddle_tpu_torch
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import _reset_unique_names as torch_reset
from paddle_tpu_torch.incubate import moe as tmoe
from paddle_tpu_torch.ops.registry import OpContext, run_kernel

import torch_dist_worker

E, D, H, N = 4, 8, 16, 64


def _params(seed=0, e=E):
    return [np.array(p) for p in
            jmoe.init_moe_params(jax.random.PRNGKey(seed), D, H, e)]


def _x(n=N, seed=5):
    return np.random.RandomState(seed).randn(n, D).astype(np.float32)


def _t(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("cf", [1.25, 0.05, 2.0])
def test_switch_moe_matches_jax(cf):
    ps, x = _params(), _x()
    y = np.tanh(x @ np.random.RandomState(3).randn(D, D)) \
        .astype(np.float32)

    def jloss(p):
        out, aux = jmoe.switch_moe(jnp.asarray(x), *p, capacity_factor=cf)
        return jnp.mean((out - y) ** 2) + 0.01 * aux, (out, aux)
    (jl, (jout, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(p) for p in ps))
    tp = _t(ps, grad=True)
    tmoe.reset_moe_stats()
    tout, taux = tmoe.switch_moe(torch.from_numpy(x), *tp,
                                 capacity_factor=cf)
    tl = ((tout - torch.from_numpy(y)) ** 2).mean() + 0.01 * taux
    tl.backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    for g, t in zip(jg, tp):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-6)
    zero_rows = int((np.abs(np.asarray(jout)).sum(-1) == 0).sum())
    assert int(tmoe.MOE_STATS["dropped"]) == zero_rows
    if cf == 0.05:
        assert zero_rows > N // 2


def test_aux_loss_and_init_match_jax():
    g_uniform = np.full((100, 4), 0.25, np.float32)
    idx = np.arange(100) % 4
    assert float(tmoe.moe_aux_loss(torch.from_numpy(g_uniform),
                                   torch.from_numpy(idx))) == pytest.approx(
        float(jmoe.moe_aux_loss(jnp.asarray(g_uniform), jnp.asarray(idx))),
        rel=1e-6)
    gen = torch.Generator().manual_seed(0)
    tp = tmoe.init_moe_params(gen, D, H, E)
    for t, j in zip(tp, _params()):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    assert float(tp[2].abs().sum()) == float(tp[4].abs().sum()) == 0.0


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe4")
    gw, w1, b1, w2, b2 = _params(e=4)
    np.savez(d / "in.npz", x=_x(), gw=gw, w1=w1, b1=b1, w2=w2, b2=b2,
             cf=np.float32(8.0))
    tdist.spawn(torch_dist_worker.moe_ep,
                args=(str(d / "rendezvous"), str(d / "in.npz"), str(d)),
                nprocs=4)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def test_expert_parallel_matches_dense(ep_world):
    ps, x = _params(e=4), _x()
    dense, _ = jmoe.switch_moe(jnp.asarray(x), *ps, capacity_factor=8.0)
    got = np.concatenate([r["out"] for r in ep_world])
    np.testing.assert_allclose(got, np.asarray(dense), rtol=2e-5, atol=2e-6)
    mesh = Mesh(np.array(jax.devices()[:4]), ("ep",))
    sharded = shard_map_unchecked(
        lambda xl, *p: jmoe.switch_moe(xl, *p, capacity_factor=8.0,
                                       axis_name="ep")[0],
        mesh, in_specs=(P("ep"), P(), P("ep"), P("ep"), P("ep"), P("ep")),
        out_specs=P("ep"))
    np.testing.assert_allclose(got, np.asarray(sharded(x, *ps)),
                               rtol=2e-5, atol=2e-6)
    op = np.concatenate([r["op_out"] for r in ep_world])
    np.testing.assert_array_equal(op, got)


def test_expert_parallel_grads_match_dense(ep_world):
    ps, x = _params(e=4), _x()

    def dense_loss(p, xx):
        o, _ = jmoe.switch_moe(xx, *p, capacity_factor=8.0)
        return jnp.mean(o ** 2)
    g, gx = jax.grad(dense_loss, argnums=(0, 1))(
        tuple(jnp.asarray(p) for p in ps), jnp.asarray(x))
    w = len(ep_world)
    # each rank's loss is the mean over its own tokens: w x the dense one's
    np.testing.assert_allclose(
        np.concatenate([r["d_x"] for r in ep_world]) / w, np.asarray(gx),
        rtol=5e-4, atol=1e-7)
    gate = sum(r["d_gw"] for r in ep_world) / w
    np.testing.assert_allclose(gate, np.asarray(g[0]), rtol=5e-4, atol=1e-6)
    for i, k in enumerate(("w1", "b1", "w2", "b2")):
        got = np.concatenate([r["d_" + k] for r in ep_world]) / w
        np.testing.assert_allclose(got, np.asarray(g[i + 1]), rtol=5e-4,
                                   atol=1e-6, err_msg=k)
    calls = json.loads(str(ep_world[0]["calls"]))
    assert calls == {"switch_moe_all_to_all": 4}


def test_switch_moe_op_matches_jax():
    ps, x = _params(), _x(16)
    names = ("GateW", "W1", "B1", "W2", "B2")
    want = jrun("switch_moe", dict(X=jnp.asarray(x), **{
        n: jnp.asarray(p) for n, p in zip(names, ps)}),
        {"capacity_factor": 1.25}, JCtx(seed=0))
    got = run_kernel("switch_moe", dict(X=torch.from_numpy(x), **{
        n: torch.from_numpy(p) for n, p in zip(names, ps)}),
        {"capacity_factor": 1.25}, OpContext(seed=0))
    np.testing.assert_allclose(got["Out"].numpy(), np.asarray(want["Out"]),
                               atol=1e-6)
    np.testing.assert_allclose(float(got["AuxLoss"]),
                               float(want["AuxLoss"]), rtol=1e-6)


def _moe_block(pkg):
    static = pkg.static
    layers = static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 6, 16])
        y = layers.data("y", [-1, 6, 16])
        h = layers.fc(x, 16, num_flatten_dims=2, act="relu")
        moe_out, aux = layers.switch_moe(h, num_experts=4, d_hidden=32,
                                         capacity_factor=2.0)
        h = layers.layer_norm(layers.elementwise_add(h, moe_out),
                              begin_norm_axis=2)
        mse = layers.mean(layers.square(layers.elementwise_sub(h, y)))
        loss = layers.elementwise_add(mse, layers.scale(aux, scale=0.01))
        static.Adam(learning_rate=5e-3).minimize(loss)
    return main, startup, loss


def test_static_moe_block_serializes_equal_and_trains_as_jax():
    jax_reset()
    jm, js, jl = _moe_block(paddle_tpu)
    torch_reset()
    tm, ts, tl = _moe_block(paddle_tpu_torch)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    rng = np.random.RandomState(0)
    xb = rng.randn(8, 6, 16).astype(np.float32)
    yb = np.tanh(xb[:, :, ::-1]).astype(np.float32)
    jexe, jscope = jstatic.Executor(), jstatic.Scope()
    texe, tscope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
    want, got = [], []
    with jstatic.scope_guard(jscope):
        jexe.run(js)
        with tstatic.scope_guard(tscope):
            texe.run(ts)
            for n in jscope.vars:
                v = jscope.find_var(n).get_tensor()
                if v is not None:
                    tscope.set(n, torch.from_numpy(np.array(v)))
            for _ in range(5):
                want.append(float(np.asarray(jexe.run(
                    jm, feed={"x": xb, "y": yb}, fetch_list=[jl])[0])))
                got.append(float(np.asarray(texe.run(
                    tm, feed={"x": xb, "y": yb}, fetch_list=[tl])[0])))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_nn_switch_moe_layer_dygraph():
    from paddle_tpu_torch import dygraph, nn
    from paddle_tpu_torch.core.place import CPUPlace
    with dygraph.guard(CPUPlace()):
        layer = nn.SwitchMoE(d_model=8, d_hidden=16, num_experts=4,
                             capacity_factor=2.0)
        x = torch.from_numpy(np.random.RandomState(0).randn(16, 8)
                             .astype(np.float32))
        out, aux = layer(x)
        assert tuple(out.shape) == (16, 8)
        ((out * out).sum() + aux * 0.01).backward()
    assert layer.gate_w.grad is not None
    assert float(layer.w1.grad.abs().sum()) > 0
    assert float(layer.w2.grad.abs().sum()) > 0
    assert sorted(n for n, _ in layer.named_parameters()) == \
        ["b1", "b2", "gate_w", "w1", "w2"]
