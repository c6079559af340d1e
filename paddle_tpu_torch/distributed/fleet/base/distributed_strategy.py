"""DistributedStrategy: the user-facing distributed-training config.

Counterpart of paddle_tpu/distributed/fleet/base/distributed_strategy.py
(the reference's distributed_strategy.proto fields as a plain attribute
object).  Field names and *_configs keys are the JAX package's, so a
strategy ports unchanged.  The NCCL-era knobs (nccl_comm_num,
hierarchical_allreduce, fuse_grad_size_in_MB) are recorded and do
nothing yet: gradient bucketing waits for ROADMAP.md Queue 1 item 1.
"""
from __future__ import annotations

import copy

__all__ = ["DistributedStrategy"]


class DistributedStrategy:
    def __init__(self):
        # collective execution
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.sync_nccl_allreduce = True
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.execution_strategy = None
        self.build_strategy = None

        # mixed precision (distributed_strategy.proto amp + amp_configs)
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "incr_every_n_steps": 1000,
            "decr_every_n_nan_or_inf": 2,
            "incr_ratio": 2.0,
            "decr_ratio": 0.8,
            "use_dynamic_loss_scaling": True,
            "custom_white_list": [],
            "custom_black_list": [],
            "custom_black_varnames": [],
            # the AMP dtype (bf16: fp32's exponent range, no loss scaling
            # needed)
            "dtype": "bfloat16",
        }

        # recompute (activation checkpointing)
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}

        # pipeline parallelism
        self.pipeline = False
        self.pipeline_configs = {"micro_batch": 1, "accumulate_steps": 1,
                                 "schedule": "gpipe"}

        # gradient merge / accumulation
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}

        # localsgd
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = {"init_k_steps": 1, "begin_step": 1}

        # gradient compression
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1,
                            "sparsity": [0.999]}
        self.fp16_allreduce = False

        # large-batch optimizers
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                             "epsilon": 0.0, "exclude_from_weight_decay": []}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01,
                             "exclude_from_weight_decay": []}

        # parameter server
        self.a_sync = False
        self.a_sync_configs = {"k_steps": -1, "max_merge_var_num": 1,
                               "send_queue_size": 16,
                               "independent_recv_thread": False,
                               "thread_pool_size": 1,
                               "send_wait_times": 1,
                               "runtime_split_send_recv": False,
                               "launch_barrier": True,
                               "geo_sgd_need_push_nums": 100}

        # misc
        self.elastic = False
        self.auto = False
        self.cudnn_exhaustive_search = False
        self.conv_workspace_size_limit = 512
        self.cudnn_batchnorm_spatial_persistent = False
        self.sync_batch_norm = False

        # the JAX package's extensions: ZeRO, tensor and sequence parallel
        # (ROADMAP.md Queue 1, Distribution)
        self.sharding = False          # ZeRO-style param sharding over dp
        self.sharding_configs = {"fuse_broadcast_MB": 32}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.sequence_parallel = False
        self.sequence_parallel_configs = {"degree": 1, "ring_attention": True}

    def save_to_prototxt(self, output):
        import json
        with open(output, "w") as f:
            json.dump({k: v for k, v in self.__dict__.items()
                       if not k.startswith("_") and k not in
                       ("execution_strategy", "build_strategy")},
                      f, indent=2, default=str)

    def load_from_prototxt(self, pb_file):
        import json
        with open(pb_file) as f:
            for k, v in json.load(f).items():
                if hasattr(self, k):
                    setattr(self, k, v)

    def __deepcopy__(self, memo):
        new = DistributedStrategy()
        for k, v in self.__dict__.items():
            if k in ("execution_strategy", "build_strategy"):
                setattr(new, k, v)
            else:
                setattr(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self):
        on = [k for k, v in self.__dict__.items() if v is True]
        return f"DistributedStrategy(enabled={on})"
