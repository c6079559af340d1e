"""paddle_tpu_torch.hapi — the high-level Model API (counterpart of
paddle_tpu/hapi/): `Model` with `prepare`, `train_batch`, `eval_batch`,
`predict_batch` and `parameters`.  `fit` / `evaluate` / `predict` (with
hapi/callbacks.py and progressbar.py), `save` / `load`, `summary` and
`prepare(use_jit=True)` raise (ROADMAP.md Queue 1, The rest)."""
from .model import Model  # noqa: F401
