"""Learning-rate schedulers.

Counterpart of paddle_tpu/optimizer/lr_scheduler.py (the 2.0 API and the
fluid dygraph CosineDecay).  A scheduler owns a persistable scalar lr var;
`step()` recomputes the value on the host and writes it into the scope
(on the device the var lives on).  The training step only reads the var,
so an lr change needs no new program: `Executor.run_steps` copies a scope
value that is not its captured buffer into the buffer before replaying,
so the lr holds for a call's K steps, as in the reference's scan."""
from __future__ import annotations

import math

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "ReduceOnPlateau",
    "CosineAnnealingDecay",
]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self._var = None
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        self._sync_var()

    def get_lr(self):
        raise NotImplementedError

    # -- static-graph integration ------------------------------------------
    def _create_static_var(self):
        if self._var is None:
            from ..static.layers import create_global_var
            from ..core.program import unique_name
            self._var = create_global_var(
                [1], self.last_lr, "float32", persistable=True,
                name=unique_name("learning_rate"))
        return self._var

    def _sync_var(self):
        if self._var is not None:
            import torch
            from ..static.executor import global_scope
            scope = global_scope()
            cur = scope.get(self._var.name)
            if cur is not None:
                scope.set(self._var.name, torch.tensor(
                    [self.last_lr], dtype=torch.float32, device=cur.device))

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state.get("last_epoch", -1)
        self.last_lr = state.get("last_lr", self.base_lr)
        self._sync_var()

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, **kw):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, **kw):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], **kw)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, **kw):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / float(decay_steps)) or 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / float(decay_steps)) ** self.power + self.end_lr)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, **kw):
        self.lr = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr, **kw)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr +
                    (self.end_lr - self.start_lr) * self.last_epoch /
                    float(self.warmup_steps))
        if isinstance(self.lr, LRScheduler):
            self.lr.step()
            return self.lr()
        return float(self.lr)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, **kw):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, **kw):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, **kw):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, **kw):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, **kw):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.last_lr if hasattr(self, "last_lr") else self.base_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            if not hasattr(self, "last_lr"):
                self.last_lr = self.base_lr
            self._sync_var()
            return
        current = float(metrics)
        better = (self.best is None or
                  (current < self.best - self._thresh() if self.mode == "min"
                   else current > self.best + self._thresh()))
        if better:
            self.best = current
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self._sync_var()

    def _thresh(self):
        if self.best is None:
            return 0.0
        if self.threshold_mode == "rel":
            return abs(self.best) * self.threshold
        return self.threshold


# 2.0-alpha "LR"-suffix aliases (reference python/paddle/optimizer/
# __init__.py exports both spellings; the Decay names are canonical)
NoamLR = NoamDecay
PiecewiseLR = PiecewiseDecay
NaturalExpLR = NaturalExpDecay
InverseTimeLR = InverseTimeDecay
PolynomialLR = PolynomialDecay
LinearLrWarmup = LinearWarmup
ExponentialLR = ExponentialDecay
MultiStepLR = MultiStepDecay
StepLR = StepDecay
LambdaLR = LambdaDecay
ReduceLROnPlateau = ReduceOnPlateau
CosineAnnealingLR = CosineAnnealingDecay

__all__ += ["NoamLR", "PiecewiseLR", "NaturalExpLR", "InverseTimeLR",
            "PolynomialLR", "LinearLrWarmup", "ExponentialLR",
            "MultiStepLR", "StepLR", "LambdaLR", "ReduceLROnPlateau",
            "CosineAnnealingLR"]


class CosineDecay(LRScheduler):
    """fluid.dygraph CosineDecay: lr * 0.5 * (cos(epoch*pi/epochs)+1)
    with epoch = step // step_each_epoch."""

    def __init__(self, learning_rate, step_each_epoch, epochs,
                 last_epoch=-1, verbose=False):
        self.step_each_epoch = int(step_each_epoch)
        self.epochs = int(epochs)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        epoch = self.last_epoch // self.step_each_epoch
        return self.base_lr * 0.5 * (
            math.cos(epoch * math.pi / self.epochs) + 1)


__all__ += ["CosineDecay"]
