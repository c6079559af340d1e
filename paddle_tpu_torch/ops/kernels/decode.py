"""The `beam_search` op: one step of beam selection.

Counterpart of paddle_tpu/ops/kernels/decode.py:31-66 (reference:
beam_search_op.cc).  Beams are a dense [batch, beam] axis: the op takes
[batch*beam, V] log-probs and emits the top-`beam` continuations per
batch group (top-k over the flattened beam*V axis).  The other decode ops
of that module (gather_tree, py_func, ...) wait for ROADMAP.md Queue
1, The rest.
"""
from __future__ import annotations

import torch

from ..registry import register_op

_NEG = -1e30


@register_op("beam_search",
             inputs=["pre_ids!", "pre_scores", "scores", "ids?!"],
             outputs=["selected_ids", "selected_scores", "parent_idx?"],
             grad=None)
def beam_search(ins, attrs, ctx):
    """One decode step.  pre_ids [B*W, 1], pre_scores [B*W, 1],
    scores [B*W, V] log-probs for the next token.  Emits the top-W
    (id, score, parent beam) per batch group.  Finished beams (pre_id ==
    end_id) are frozen: they re-emit end_id with unchanged score."""
    beam_size = int(attrs["beam_size"])
    end_id = int(attrs.get("end_id", 1))
    pre_ids = ins["pre_ids"].reshape(-1)
    pre_scores = ins["pre_scores"].reshape(-1).float()
    scores = ins["scores"].float()
    BW, V = scores.shape
    B = BW // beam_size
    finished = pre_ids == end_id
    # frozen beams contribute exactly one candidate: end_id at the old
    # score; live beams add log-probs
    cand = pre_scores[:, None] + torch.where(
        finished[:, None], torch.full_like(scores, _NEG), scores)
    keep_end = torch.where(finished, pre_scores,
                           torch.full_like(pre_scores, _NEG))
    cand[:, end_id] = torch.maximum(cand[:, end_id], keep_end)
    # first step convention: only beam 0 of each group is live (the rest
    # duplicate it)
    if attrs.get("first_step", False):
        live = (torch.arange(BW, device=cand.device) % beam_size) == 0
        cand = torch.where(live[:, None], cand,
                           torch.full_like(cand, _NEG))
    flat = cand.reshape(B, beam_size * V)
    top_s, top_i = torch.topk(flat, beam_size, dim=1, sorted=True)
    parent = top_i // V
    token = top_i % V
    parent_global = parent + torch.arange(B, device=cand.device)[:, None] \
        * beam_size
    return {"selected_ids": token.reshape(-1, 1).to(torch.int64),
            "selected_scores": top_s.reshape(-1, 1),
            "parent_idx": parent_global.reshape(-1).to(torch.int64)}
