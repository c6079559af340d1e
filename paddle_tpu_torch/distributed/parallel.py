"""Process-group bootstrap and dygraph data parallel.

Counterpart of paddle_tpu/distributed/parallel.py (`init_parallel_env`,
`get_rank`, `get_world_size`, `prepare_context`, `DataParallel`).  The
JAX package joins one process per host to jax.distributed and drives the
local chips through a mesh; the port runs one process per rank and
forms a torch.distributed process group from the PADDLE_* contract
(parallel_env.py): rank 0's endpoint in PADDLE_TRAINER_ENDPOINTS is the
TCP rendezvous, unless an `init_method` (a `file://` path, say) is
given.  The backend is NCCL where every rank has a CUDA device of its
own, gloo otherwise, unless `backend=` names one.

`DataParallel.scale_loss` divides the loss by the world size and
`apply_collective_grads` allreduces (sums) each gradient, one collective
a parameter, as the JAX package does; the reference's coalescing of
gradients into buckets waits for ROADMAP.md Queue 1 item 1.
"""
from __future__ import annotations

import torch

from .parallel_env import ParallelEnv

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "prepare_context", "DataParallel", "ParallelEnv"]


def _dist():
    import torch.distributed as dist
    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank: the process group's when one is
    initialised, else PADDLE_TRAINER_ID."""
    return _dist().get_rank() if _initialized() else ParallelEnv().rank


def get_world_size() -> int:
    """The process group's size when one is initialised, else
    PADDLE_TRAINERS_NUM."""
    return _dist().get_world_size() if _initialized() \
        else ParallelEnv().world_size


def _default_backend(env: ParallelEnv) -> str:
    # NCCL refuses two ranks on one device
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= env.world_size:
        return "nccl"
    return "gloo"


def init_parallel_env(backend=None, init_method=None):
    """Form the process group of this launched rank.  A world of one with
    no `init_method` forms none (every collective is then the identity);
    a second call returns at once.  With NCCL the rank's device
    (FLAGS_selected_gpus) becomes the current CUDA device."""
    env = ParallelEnv()
    if _initialized():
        return env
    if env.world_size <= 1 and init_method is None and backend is None:
        return env
    backend = backend or _default_backend(env)
    if init_method is None:
        if not env.trainer_endpoints:
            raise ValueError(
                "init_parallel_env: PADDLE_TRAINER_ENDPOINTS is empty and "
                "no init_method was given (launch the ranks with "
                "paddle_tpu_torch.distributed.launch or spawn)")
        init_method = "tcp://" + env.trainer_endpoints[0]
    if backend == "nccl":
        torch.cuda.set_device(env.device_id)
    _dist().init_process_group(backend, init_method=init_method,
                               world_size=env.world_size, rank=env.rank)
    from .collective import _reset_groups
    _reset_groups()
    return env


def prepare_context(strategy=None):
    """fluid.dygraph.parallel.prepare_context, the legacy name."""
    init_parallel_env()
    return strategy


class DataParallel:
    """Dygraph data parallel:

        model = DataParallel(model)
        loss = model.scale_loss(loss)
        loss.backward()
        model.apply_collective_grads()
        opt.minimize(loss)
    """

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, group=None):
        self._layers = layers
        self._group = group
        # comm_buffer_size: kept for signature parity (no bucketing yet)

    @property
    def nranks(self):
        from .collective import _nranks
        return _nranks(self._group) if _initialized() \
            else ParallelEnv().world_size

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    __call__ = forward

    def scale_loss(self, loss):
        """The loss over the world size, so the summed gradients average."""
        n = self.nranks
        if n <= 1:
            return loss
        return loss / float(n)

    def apply_collective_grads(self):
        """Allreduce (sum) every trainable parameter's gradient."""
        from .collective import all_reduce, ReduceOp
        if self.nranks <= 1:
            return
        for p in self._layers.parameters():
            if p.requires_grad and p.grad is not None:
                all_reduce(p.grad, op=ReduceOp.SUM, group=self._group)

    # -- the wrapped Layer --------------------------------------------------
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def sublayers(self, include_self=False):
        return self._layers.sublayers(include_self)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, state_dict, *a, **kw):
        return self._layers.set_state_dict(state_dict, *a, **kw)

    set_dict = set_state_dict
    load_dict = set_state_dict

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)
