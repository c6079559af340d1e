"""The switch_moe op.  Counterpart of the op of the same name in
paddle_tpu/ops/kernels/sparse_feature.py (the module's other ops are not
ported: ROADMAP.md Queue 1, The rest)."""
from __future__ import annotations

from ..registry import register_op
from . import collective as _kc


def switch_moe_nd(x, gate_w, w1, b1, w2, b2, capacity_factor=1.25,
                  ep_ring_id=None):
    """incubate.moe.switch_moe over X [..., D] (the leading dims are the
    tokens): the expert group is the one bound to `ep_ring_id` through
    the ring registry; off a bound ring every expert is local."""
    from ...incubate.moe import switch_moe
    group = None
    if ep_ring_id is not None and x.device.type != "meta":
        group = _kc.bound_group(int(ep_ring_id))
    lead = x.shape[:-1]
    out, aux = switch_moe(x.reshape(-1, x.shape[-1]), gate_w, w1, b1, w2,
                          b2, capacity_factor=float(capacity_factor),
                          group=group)
    return out.reshape(*lead, x.shape[-1]), aux.reshape(())


@register_op("switch_moe",
             inputs=["X", "GateW", "W1", "B1", "W2", "B2"],
             outputs=["Out", "AuxLoss"])
def switch_moe_op(ins, attrs, ctx):
    """Top-1 switch MoE feed-forward as a Program op (incubate/moe.py's
    core).  X [..., D]; the expert weights carry a leading E axis (this
    rank's E / ep experts when attrs['ep_ring_id'] is bound to a group).
    The derived gradient replays the forward (its all-to-alls included)
    under torch.func.vjp, then runs the reverse all-to-alls."""
    out, aux = switch_moe_nd(ins["X"], ins["GateW"], ins["W1"], ins["B1"],
                             ins["W2"], ins["B2"],
                             attrs.get("capacity_factor", 1.25),
                             attrs.get("ep_ring_id"))
    return {"Out": out, "AuxLoss": aux}
