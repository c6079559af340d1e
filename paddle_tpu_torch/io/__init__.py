"""paddle.io — datasets, samplers, the DataLoader, and model and
parameter IO (counterpart of paddle_tpu/io; the generator loader,
bucketing, crypto and the data feeder wait for ROADMAP.md Queue 1, The
rest)."""
from .dataset import (  # noqa: F401
    Dataset, IterableDataset, TensorDataset, ComposeDataset, ChainDataset,
    ConcatDataset, Subset, random_split,
)
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, WeightedRandomSampler,
    BatchSampler, DistributedBatchSampler,
)
from .dataloader import (DataLoader, default_collate_fn,  # noqa: F401
                         get_worker_info, WorkerInfo, ParentWatchDog)
from .framework_io import (  # noqa: F401
    save_vars, save_params, save_persistables, load_vars, load_params,
    load_persistables, save_inference_model, load_inference_model,
    load_params_from_numpy, is_persistable,
)
