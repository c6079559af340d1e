"""SelectedRows: sparse row-slice gradients.

Counterpart of paddle_tpu/core/selected_rows.py: a {rows, values, height}
triple, the embedding gradient of `is_sparse=True`, so the optimizer
touches only the looked-up rows.  Duplicate rows are allowed and not
merged eagerly: `to_dense` and the optimizers scatter-add them with
`index_put_(accumulate=True)` (the sort-based kernel on the card, which
sums duplicates in a fixed order, with no host read and static shapes:
`B * S` rows whatever the ids).  The executor carries the object through
its environment like a tensor; kernels that take one (sgd, momentum,
adam, scale, sum) test for it.
"""
from __future__ import annotations

import torch

__all__ = ["SelectedRows"]


class SelectedRows:
    """rows: int64 [n] indices into a table of `height` rows; values:
    [n, ...] per-row updates.  Scatter-add semantics over duplicates."""

    def __init__(self, rows, values, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def device(self):
        return self.values.device

    def to_dense(self):
        """Densify by scatter-add (duplicate rows summed)."""
        out = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        return out.index_put_((self.rows,), self.values, accumulate=True)

    def row_mask(self):
        """Boolean [height] mask of the touched rows."""
        m = torch.zeros((self.height,), dtype=torch.bool,
                        device=self.values.device)
        return m.index_put_((self.rows,), torch.ones((), dtype=torch.bool,
                                                     device=m.device))

    def __repr__(self):
        return (f"SelectedRows(n={self.values.shape[0]}, "
                f"height={self.height}, width={tuple(self.values.shape[1:])})")
