"""StrategyCompiler — pick and chain the applicable meta-optimizers.

Counterpart of paddle_tpu/distributed/fleet/base/strategy_compiler.py.

Reference: fleet/base/strategy_compiler.py (`StrategyCompiler.generate_optimizer`,
called from fleet_base.py:1032) — filters candidates by `_can_apply`,
resolves incompatibilities (first-enabled wins; losers' strategy flags are
disabled), and chains survivors inner→outer via `_update_inner_optimizer`.
"""
from __future__ import annotations

__all__ = ["StrategyCompiler"]


class StrategyCompiler:
    def __init__(self):
        self._meta_optimizers = []
        self._graph_optimizer = None

    def generate_optimizer(self, loss, role_maker, optimizer,
                           user_defined_strategy, meta_optimizer_list):
        applicable = []
        for meta in meta_optimizer_list:
            meta._set_basic_info(loss, role_maker, optimizer,
                                 user_defined_strategy)
            if meta._can_apply():
                applicable.append(meta)

        # resolve incompatibilities (both directions): earlier (inner)
        # optimizer wins
        chosen = []
        for meta in applicable:
            name = type(meta).__name__
            if any(name in m._incompatible or
                   type(m).__name__ in meta._incompatible
                   for m in chosen):
                meta._disable_strategy(user_defined_strategy)
                continue
            chosen.append(meta)

        # chain inner→outer
        inner = optimizer
        for meta in chosen:
            meta._update_inner_optimizer(inner)
            inner = meta
        self._meta_optimizers = chosen
        self._graph_optimizer = next(
            (m for m in chosen if m._is_graph_out()), None)
        return inner, chosen
