"""Shared host-side beam-search orchestration for model decode loops.

Counterpart of paddle_tpu/models/_decode.py: models supply a callback
producing next-token logits for the current [batch*beam, T] candidate
matrix; the loop drives the registered `beam_search` op (the port's
ops/kernels/decode.py, on CPU tensors: the candidates are a few hundred
numbers a step) and re-gathers histories by parent index."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["beam_search_loop"]


def beam_search_loop(step_logits: Callable[[np.ndarray], np.ndarray],
                     init_ids: np.ndarray, beam_size: int, eos_id: int,
                     max_steps: int, length_penalty: float = 0.0):
    """Returns the best hypothesis per batch group, [batch, T].

    length_penalty: GNMT alpha — final ranking uses
    score / ((5 + len) / 6) ** alpha (0.0 = raw cumulative log-prob)."""
    from ..ops.registry import OpContext, run_kernel
    W = max(1, int(beam_size))
    batch, prefix = init_ids.shape
    trg = np.repeat(init_ids, W, axis=0)          # [B*W, prefix]
    pre_scores = np.zeros((batch * W, 1), np.float32)
    ctx = OpContext()
    for step in range(max_steps):
        logits = step_logits(trg)                 # [B*W, V]
        logp = torch.log_softmax(torch.as_tensor(logits), dim=-1)
        sel = run_kernel(
            "beam_search",
            {"pre_ids": torch.as_tensor(trg[:, -1:]),
             "pre_scores": torch.as_tensor(pre_scores),
             "scores": logp, "ids": None},
            {"beam_size": W, "end_id": eos_id,
             "first_step": step == 0}, ctx)
        tokens = sel["selected_ids"].numpy().reshape(-1, 1)
        pre_scores = sel["selected_scores"].numpy()
        parents = sel["parent_idx"].numpy().reshape(-1)
        trg = np.concatenate([trg[parents], tokens.astype(np.int64)], 1)
        if (trg[:, -1] == eos_id).all():
            break
    # final ranking with GNMT length normalization
    gen = trg[:, prefix:]
    lens = np.where((gen == eos_id).any(1),
                    (gen == eos_id).argmax(1) + 1, gen.shape[1])
    norm = ((5.0 + lens) / 6.0) ** float(length_penalty)
    ranked = (pre_scores[:, 0] / norm).reshape(batch, W)
    best = ranked.argmax(1)
    return trg.reshape(batch, W, -1)[np.arange(batch), best]
