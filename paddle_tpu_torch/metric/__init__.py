"""paddle.metric — Accuracy / Precision / Recall / Auc (counterpart of
paddle_tpu/metric/).  The static-graph `auc`, `chunk_eval` and
`mean_iou` layers wait for their ops (ROADMAP.md Queue 1, The rest)."""
from .metrics import Metric, Accuracy, Precision, Recall, Auc  # noqa: F401

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def accuracy(input, label, k=1):
    """Functional top-k accuracy over a batch (metric_op.py accuracy)."""
    m = Accuracy(topk=(k,))
    return m.update(m.compute(input, label))
