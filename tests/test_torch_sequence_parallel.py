"""Sequence parallelism in the port (ops/attention.py's ring_attention,
the ring_attention op, static/nets.py's sequence_parallel=True, the sp
programs of models/static_lm.py and models/bert_static.py, and
CompiledProgram's dp x sp world) against the JAX package on the CPU.

  * `ring_attention` on 2 and 4 gloo ranks (each its sequence shard),
    causal and not: the output within rtol 1e-5 / atol 1e-6 of the JAX
    `ring_attention` under `shard_map` over an "sp" axis of as many
    devices, and the gradients of sum(out * dO) within 1e-5 of the JAX
    package's (tests/test_attention.py:106,127);
  * the ring decomposition in one process (`ring_blocks`): the plain
    ring and the flash-composed ring (its CPU plain kernels) at 1, 2
    and 4 blocks against plain attention, forward and backward;
  * the one-op program of tests/test_attention.py:191 on a dp2 x sp2
    world (4 ranks): the loss within rtol 1e-5 of the JAX package's on
    its (2, 2) mesh and of the single-device run;
  * `build_transformer_lm(sequence_parallel=True)` (test_attention.py:354,
    without its FLAGS_recompute part) and BERT with `use_ring` serialize
    equal to the JAX programs; the language model trains 3 SGD steps on
    dp1 x sp2 and dp2 x sp2 as the JAX CompiledProgram on the same mesh
    shapes: losses within rtol 1e-5, the global state within
    rtol 2e-5 / atol 2e-6;
  * the refusals the JAX package keeps: sp together with tp, ZeRO under
    sp, attention dropout with sequence_parallel=True; the flash op under
    a bound sp ring.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu
import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset
from paddle_tpu.distributed.compiled_program import (
    BuildStrategy as JBuild, CompiledProgram as JCompiled)
from paddle_tpu.ops.attention import ring_attention as jring
from paddle_tpu.utils.shard_map_compat import shard_map_unchecked

import paddle_tpu_torch
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import _reset_unique_names as torch_reset
from paddle_tpu_torch.ops import attention as tattn

import torch_dist_worker
from torch_dist_worker import build_ring_op, build_sp_lm
from test_torch_program import flash_mode
from test_torch_sharding import _state_after_startup

B, H, S, D = 2, 3, 16, 8
RINGS = ["plain", "causal"]
STEPS = 3


def _ring_inputs(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name in RINGS:
        for x in ("q", "k", "v", "do"):
            out[f"{name}/{x}"] = rng.randn(B, H, S, D).astype(np.float32)
    return out


def _jax_ring(data, name, n):
    """The JAX ring over an n-device "sp" axis: out and the grads of
    sum(out * dO)."""
    causal = name.startswith("causal")
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = P(None, None, "sp", None)
    f = shard_map_unchecked(lambda q, k, v: jring(q, k, v, "sp",
                                                  causal=causal),
                            mesh, in_specs=(spec,) * 3, out_specs=spec)
    q, k, v, do = (jnp.asarray(data[f"{name}/{x}"])
                   for x in ("q", "k", "v", "do"))
    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    return [np.asarray(t) for t in (out,) + vjp(do)]


def _lm_feeds(steps, batch=4, seq=16, vocab=64, seed=11):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(steps):
        out[f"ids{i}"] = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
        out[f"pos{i}"] = np.tile(np.arange(seq), (batch, 1)).astype(np.int64)
        out[f"labels{i}"] = rng.randint(0, vocab, (batch, seq, 1)) \
            .astype(np.int64)
    return out


def _op_feed():
    return {"q0": np.random.RandomState(0).rand(4, 32, 32)
            .astype(np.float32)}


def _spawn(d, nprocs, programs):
    data = _ring_inputs()
    np.savez(d / "rings.npz", **data)
    np.savez(d / "lm_feeds.npz", **_lm_feeds(STEPS))
    np.savez(d / "op_feeds.npz", **_op_feed())
    jax_reset()
    state = _state_after_startup(build_sp_lm(paddle_tpu))
    np.savez(d / "lm_state.npz", **state)
    cfg = {"rings": RINGS, "programs": {}}
    for name, (model, sp) in programs.items():
        cfg["programs"][name] = (
            {"model": "op", "sp": sp, "steps": 1, "feed_names": ["q"],
             "feeds": str(d / "op_feeds.npz")} if model == "op" else
            {"model": model, "sp": sp, "steps": STEPS,
             "feed_names": ["ids", "pos", "labels"],
             "feeds": str(d / "lm_feeds.npz"),
             "state": str(d / "lm_state.npz")})
    tdist.spawn(torch_dist_worker.sp_ring,
                args=(str(d / "rendezvous"), str(d / "rings.npz"), str(d),
                      cfg), nprocs=nprocs)
    return data, state, [dict(np.load(d / f"rank{r}.npz"))
                         for r in range(nprocs)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sp2"), 2,
                  {"lm_dp1_sp2": ("lm", 2), "fleet_dp1_sp2": ("fleet", 2)})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sp4"), 4,
                  {"op_dp2_sp2": ("op", 2), "lm_dp2_sp2": ("lm", 2)})


def _check_ring(world, n):
    data, _, ranks = world
    for name in RINGS:
        want = _jax_ring(data, name, n)
        for i, x in enumerate(("out", "dq", "dk", "dv")):
            got = np.concatenate([r[f"{name}/{x}"] for r in ranks], axis=2)
            np.testing.assert_allclose(got, want[i], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {x}")
    # every rank sent its K/V block on n - 1 steps forward and backward
    # (the backward with its dK/dV sums, fp32), plus the sums' last hop
    blk = B * H * (S // n) * D * 4
    per_ring = (n - 1) * 2 * blk + (n - 1) * 4 * blk + 2 * blk
    assert int(ranks[0]["ring_bytes"]) == len(RINGS) * per_ring


def test_ring_sp2_matches_jax(world2):
    _check_ring(world2, 2)


def test_ring_sp4_matches_jax(world4):
    _check_ring(world4, 4)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("flash", [False, True])
def test_ring_blocks_match_plain_attention(n, causal, flash):
    """The ring's steps in one process: n blocks, forward (the JAX step
    arithmetic, or the flash forward's plain version merged by lse) and
    the backward ring (plain dQ and dK/dV with the global lse)."""
    rng = np.random.RandomState(n * 7 + causal)
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, S, D)
                                    .astype(np.float32)) for _ in range(4))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    tattn.reference_attention(qr, kr, vr, causal=causal).backward(do)
    sl, scale = S // n, 1 / math.sqrt(D)

    def cut(t):
        return [t[:, :, i * sl:(i + 1) * sl] for i in range(n)]
    res = tattn.ring_blocks([
        tattn._ring_fwd_rank(*blk, i, n, causal, scale, flash)
        for i, blk in enumerate(zip(cut(q), cut(k), cut(v)))])
    out = torch.cat([x[0] for x in res], 2)
    lse = torch.cat([x[1] for x in res], 2)
    want = tattn.reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-6)
    grads = tattn.ring_blocks([
        tattn._ring_bwd_rank(*blk, i, n, causal, scale, False)
        for i, blk in enumerate(zip(
            cut(q), cut(k), cut(v), cut(out),
            [lse[:, :, i * sl:(i + 1) * sl] for i in range(n)], cut(do)))])
    for j, t in enumerate((qr, kr, vr)):
        got = torch.cat([g[j] for g in grads], 2)
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), atol=2e-6)


def test_ring_op_dp2_sp2_matches_jax(world4):
    _, _, ranks = world4
    jax_reset()
    main, startup, loss = build_ring_op(paddle_tpu)
    bs = JBuild()
    bs.sequence_parallel_degree = 2
    cp = JCompiled(main, build_strategy=bs).with_data_parallel(
        places=jax.devices()[:4])
    feed = {"q": _op_feed()["q0"]}
    exe, scope = jstatic.Executor(), jstatic.Scope()
    with jstatic.scope_guard(scope):
        exe.run(startup)
        want, = exe.run(cp, feed=feed, fetch_list=[loss])
        single, = exe.run(main, feed=feed, fetch_list=[loss])
    for r in ranks:
        np.testing.assert_allclose(r["op_dp2_sp2/losses"][0], float(want),
                                   rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["op_dp2_sp2/losses"][0],
                               float(single), rtol=1e-5)
    # the one-process port run of the same program (the op off a ring)
    torch_reset()
    tm, ts, tl = build_ring_op(paddle_tpu_torch)
    texe, tscope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
    with tstatic.scope_guard(tscope):
        texe.run(ts)
        got, = texe.run(tm, feed=feed, fetch_list=[tl])
    np.testing.assert_allclose(float(got), float(single), rtol=1e-5)


def _jax_lm(state, sp, n_dev):
    jax_reset()
    main, startup, loss = build_sp_lm(paddle_tpu)
    bs = JBuild()
    bs.sequence_parallel_degree = sp
    cp = JCompiled(main, build_strategy=bs).with_data_parallel(
        loss_name=loss.name, places=jax.devices()[:n_dev])
    feeds = _lm_feeds(STEPS)
    exe, scope = jstatic.Executor(), jstatic.Scope()
    losses = []
    with jstatic.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set(n, v)
        for i in range(STEPS):
            lv, = exe.run(cp, feed={n: feeds[f"{n}{i}"]
                                    for n in ("ids", "pos", "labels")},
                          fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        st = {n: np.asarray(scope.find_var(n).get_tensor())
              for n in scope.vars
              if scope.find_var(n).get_tensor() is not None}
    return np.asarray(losses), st


def _check_state(ranks, name, want):
    got = {k[len(name) + 7:]: v for k, v in ranks[0].items()
           if k.startswith(name + "/state/")}
    for r in ranks[1:]:
        for n, v in got.items():
            np.testing.assert_array_equal(r[f"{name}/state/{n}"], v)
    assert got
    for n, v in got.items():
        np.testing.assert_allclose(v, np.asarray(want[n], np.float32),
                                   rtol=2e-5, atol=2e-6, err_msg=n)


@pytest.mark.parametrize("name,sp,n_dev,fix",
                         [("lm_dp1_sp2", 2, 2, "world2"),
                          ("lm_dp2_sp2", 2, 4, "world4")])
def test_sp_lm_trains_as_jax(name, sp, n_dev, fix, request):
    _, state, ranks = request.getfixturevalue(fix)
    want_losses, want = _jax_lm(state, sp, n_dev)
    for r in ranks:
        np.testing.assert_allclose(r[name + "/losses"], want_losses,
                                   rtol=1e-5)
    _check_state(ranks, name, want)


def test_fleet_sequence_parallel_runs(world2):
    """fleet's strategy.sequence_parallel reaches the BuildStrategy: the
    fleet-minimized language model trains to the bit as the
    CompiledProgram built by hand."""
    _, _, ranks = world2
    for r in ranks:
        assert r["fleet_dp1_sp2/losses"].tobytes() == \
            r["lm_dp1_sp2/losses"].tobytes()
        for key, v in r.items():
            if key.startswith("lm_dp1_sp2/state/"):
                assert v.tobytes() == r["fleet" + key[2:]].tobytes(), key


@pytest.mark.parametrize("flash", [False, True])
def test_sp_programs_serialize_equal(flash):
    from paddle_tpu.models import build_transformer_lm as jlm
    from paddle_tpu_torch.models import build_transformer_lm as tlm
    with flash_mode(flash):
        jax_reset()
        ref = jlm(96, 64, 2, 4, 16, sequence_parallel=True)
        torch_reset()
        port = tlm(96, 64, 2, 4, 16, sequence_parallel=True)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    assert sum(op.type == "ring_attention"
               for op in port[0].global_block().ops) == 2
    import bench
    from paddle_tpu_torch.models import build_bert_pretrain
    with flash_mode(flash):
        jax_reset()
        ref = bench.build_bert_base(vocab=128, seq=32, hidden=64,
                                    layers_n=2, heads=4, use_amp=True,
                                    use_ring=True)
        torch_reset()
        port = build_bert_pretrain(vocab=128, seq=32, hidden=64, layers_n=2,
                                   heads=4, use_amp=True, use_ring=True)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()


def test_sp_refusals():
    from paddle_tpu_torch.static import layers, nets
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = layers.data("x", [-1, 8, 16])
        with pytest.raises(ValueError, match="dropout"):
            nets.scaled_dot_product_attention(x, x, x, num_heads=2,
                                              dropout_rate=0.1,
                                              sequence_parallel=True)
    torch_reset()
    lm = build_sp_lm(paddle_tpu_torch)[0]
    bs = tstatic.BuildStrategy()
    bs.sequence_parallel_degree = 2
    bs.tensor_parallel_degree = 2
    with pytest.raises(NotImplementedError, match="cannot both exceed 1"):
        tstatic.CompiledProgram(lm, bs).with_data_parallel()._get_program()
    zero = torch_dist_worker.build_zero_mlp(paddle_tpu_torch, stage=1,
                                            dp=1)[0]
    bs = tstatic.BuildStrategy()
    bs.sequence_parallel_degree = 1
    cp = tstatic.CompiledProgram(zero, bs).with_data_parallel()
    cp._get_program()  # ZeRO at sp 1 is fine
    # under a bound sp ring the flash op refuses (shard-local attention)
    from paddle_tpu_torch.ops.kernels import collective as kc
    from paddle_tpu_torch.ops.registry import OpContext, run_kernel
    t = torch.zeros(1, 1, 4, 8)
    with pytest.raises(RuntimeError, match="ring_attention"):
        with _bound_sp_ring():
            run_kernel("flash_attention", {"Q": t, "K": t, "V": t}, {},
                       OpContext())


class _bound_sp_ring:
    """A one-rank gloo group bound to SP_RING_ID for the block."""

    def __enter__(self):
        import tempfile
        import torch.distributed as dist
        from paddle_tpu_torch.ops.kernels import collective as kc
        self.dir = tempfile.mkdtemp()
        dist.init_process_group("gloo", init_method="file://" + self.dir
                                + "/rdv", rank=0, world_size=1)
        kc.register_ring(tattn.SP_RING_ID, dist.group.WORLD)

    def __exit__(self, *exc):
        import torch.distributed as dist
        from paddle_tpu_torch.ops.kernels import collective as kc
        kc._RINGS.pop(tattn.SP_RING_ID, None)
        dist.destroy_process_group()
