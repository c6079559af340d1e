"""Mixture-of-Experts with switch (top-1) routing and expert parallelism.

Counterpart of paddle_tpu/incubate/moe.py, with its arithmetic:

  * routing is static-shape: the top-1 expert of each token, a capacity
    C = max(1, int(capacity_factor * N / E)) per expert, dispatch into a
    dense [E, C, D] buffer (tokens over capacity are dropped: standard
    Switch semantics) and the combine gathering each token's slot scaled
    by its gate probability;
  * the experts are batched products over the expert axis
    ([E, C, D] x [E, D, H], tanh-approximated GELU, [E, C, H] x
    [E, H, D]), as torch.einsum: the JAX package computes them outside
    any Pallas kernel too;
  * expert parallelism: with `group`, w1 / w2 hold this rank's
    E / ep experts and the dispatch and the combine go through the
    port's `all_to_all` (ops/kernels/collective.py) inside an autograd
    Function whose backward is the reverse all-to-all, so tokens travel
    to their expert's rank and back, and the experts' gradients come
    home the same way.  C is computed from this rank's N, so an expert
    receives up to ep x C tokens.

`MOE_STATS["dropped"]` sums the tokens the calls since
`reset_moe_stats()` dropped for capacity (a device tensor: reading it is
a host sync); a forward that torch.func replays for a gradient (the
static grad op) is not counted again.
"""
from __future__ import annotations

import torch

from ..ops.kernels import collective as _kc

__all__ = ["switch_moe", "moe_aux_loss", "init_moe_params", "MOE_STATS",
           "reset_moe_stats"]

MOE_STATS = {"dropped": 0}


def reset_moe_stats():
    MOE_STATS["dropped"] = 0


def _count_dropped(keep):
    # under torch.func (a grad op's replay) the tensors are wrappers that
    # must not outlive the transform, and the forward was counted already;
    # a build's shape inference runs on meta tensors, which drop nothing
    if keep.device.type != "meta" and \
            not torch._C._functorch.is_functorch_wrapped_tensor(keep):
        MOE_STATS["dropped"] = MOE_STATS["dropped"] + (~keep).sum()


def init_moe_params(generator: torch.Generator, d_model: int,
                    d_hidden: int, n_experts: int, dtype=torch.float32,
                    device=None):
    """(gate_w, w1, b1, w2, b2), the expert weights with a leading E axis,
    drawn from `generator` (the JAX package takes a PRNG key: the two
    draw different numbers, so parity tests copy the weights)."""
    s1 = (2.0 / (d_model + d_hidden)) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype) \
            .to(device)
    return (normal(d_model, n_experts) * 0.02,
            normal(n_experts, d_model, d_hidden) * s1,
            torch.zeros((n_experts, d_hidden), dtype=dtype, device=device),
            normal(n_experts, d_hidden, d_model) * s1,
            torch.zeros((n_experts, d_model), dtype=dtype, device=device))


def moe_aux_loss(gates, expert_idx):
    """Switch load-balancing loss: E * sum_e f_e * p_e (Switch Transformer
    eq. 4)."""
    E = gates.shape[-1]
    onehot = torch.nn.functional.one_hot(expert_idx, E).to(gates.dtype)
    return E * torch.sum(onehot.mean(dim=0) * gates.mean(dim=0))


class _AllToAll(torch.autograd.Function):
    """The all-to-all of dim-0 chunks over `group`, differentiable: its
    gradient is the same exchange of the cotangent (the transpose of
    "chunk j to rank j, received in rank order" is itself)."""

    @staticmethod
    def forward(x, group):
        _kc._count_op("switch_moe_all_to_all")
        return _kc.all_to_all(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        # a Function of its own inside, so the collective gets plain
        # tensors also when torch.func.vjp (the grad ops) runs this
        return _AllToAll.apply(g.contiguous(), ctx.group), None


def switch_moe(x, gate_w, w1, b1, w2, b2, capacity_factor: float = 1.25,
               group=None):
    """Top-1 MoE feed-forward.  x: [N, D] tokens.  Without `group` w1 / w2
    hold ALL experts ([E, D, H] / [E, H, D]); with `group` (a process
    group of ep ranks) this rank's [E / ep, ...] shard, and the tokens
    go to their expert's rank by all-to-all.  Returns (out [N, D],
    aux_loss scalar)."""
    N, D = x.shape
    E = gate_w.shape[1]
    ep = _kc.world_of(group)
    e_local = w1.shape[0]
    if e_local * ep != E:
        raise ValueError(
            f"gate has {E} experts but weights hold {e_local} x ep={ep}")
    gates = torch.softmax(x.float() @ gate_w.float(), dim=-1)
    expert_idx = gates.argmax(dim=-1)                       # [N]
    prob = gates.max(dim=-1).values.to(x.dtype)             # [N]
    aux = moe_aux_loss(gates, expert_idx)

    C = max(1, int(capacity_factor * N / E))
    onehot = torch.nn.functional.one_hot(expert_idx, E)
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1)       # 1-based
    keep = pos <= C
    slot = torch.where(keep, pos - 1, torch.full_like(pos, C))
    _count_dropped(keep)

    # dispatch [E, C, D]: the overflow slot C is dropped with the slice
    disp = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    disp = disp.index_put((expert_idx, slot),
                          torch.where(keep[:, None], x, torch.zeros_like(x)),
                          accumulate=True)[:, :C]
    if group is not None:
        # chunk j (rank j's experts) to rank j: this rank ends with its own
        # experts' tokens from every rank, [ep, E_local, C, D]
        disp = _AllToAll.apply(disp.contiguous(), group)
        disp = disp.reshape(ep, e_local, C, D).transpose(0, 1) \
            .reshape(e_local, ep * C, D)
    h = torch.nn.functional.gelu(
        torch.einsum("ecd,edh->ech", disp, w1) + b1[:, None, :],
        approximate="tanh")
    out_e = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    if group is not None:
        out_e = out_e.reshape(e_local, ep, C, D).transpose(0, 1) \
            .reshape(E, C, D)
        out_e = _AllToAll.apply(out_e.contiguous(), group)
    # combine: each token's slot (a dropped token's is masked to 0)
    tok = out_e[expert_idx, slot.clamp(max=C - 1)]
    out = torch.where(keep[:, None], tok, torch.zeros_like(tok)) \
        * prob[:, None]
    return out.to(x.dtype), aux
