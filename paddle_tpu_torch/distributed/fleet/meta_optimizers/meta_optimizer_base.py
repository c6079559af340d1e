"""MetaOptimizerBase: composable distributed-strategy optimizers.

Counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
meta_optimizer_base.py: a meta-optimizer wraps the user optimizer (or an
inner meta-optimizer), says from the DistributedStrategy whether it
applies (`_can_apply`) and rewrites the program in `minimize`; the
StrategyCompiler chains the applicable ones inner to outer.
"""
from __future__ import annotations

__all__ = ["MetaOptimizerBase"]


class MetaOptimizerBase:
    # subclasses list meta-optimizers they cannot compose with
    _incompatible = ()

    def __init__(self, optimizer):
        self.inner_opt = optimizer
        self.role_maker = None
        self.user_defined_optimizer = optimizer
        self.user_defined_strategy = None

    def _set_basic_info(self, loss, role_maker, user_defined_optimizer,
                        user_defined_strategy):
        self.loss = loss
        self.role_maker = role_maker
        self.user_defined_optimizer = user_defined_optimizer
        self.user_defined_strategy = user_defined_strategy

    def _update_inner_optimizer(self, optimizer):
        self.inner_opt = optimizer

    def _can_apply(self) -> bool:
        return False

    def _is_graph_out(self) -> bool:
        """True for the outermost executor-producing optimizer
        (GraphExecutionOptimizer)."""
        return False

    def _disable_strategy(self, dist_strategy):
        pass

    def _enable_strategy(self, dist_strategy, context=None):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self.inner_opt.backward(loss, startup_program,
                                       parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        return self.inner_opt.apply_gradients(params_grads)

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        return self.inner_opt.minimize(loss, startup_program,
                                       parameter_list, no_grad_set)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return self.minimize_impl(loss, startup_program, parameter_list,
                                  no_grad_set)
