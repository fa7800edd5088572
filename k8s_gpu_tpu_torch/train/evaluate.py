"""Evaluation: teacher-forced loss and perplexity over a token stream,
the port of ``k8s_gpu_tpu/train/evaluate.py``.  One forward without
gradients per batch (flash attention in the CUDA kernel on the card),
pure next-token cross-entropy (no MoE aux term)."""

from __future__ import annotations

import math

import numpy as np
import torch


@torch.no_grad()
def evaluate_lm(model, params, batches) -> dict:
    """``batches``: iterable of [B, S+1] int token arrays (targets are the
    shifted inputs, the trainer's convention).  Returns the token-weighted
    mean NLL, the perplexity and the token count."""
    total_nll = 0.0
    total_tokens = 0
    for toks in batches:
        toks = torch.as_tensor(np.asarray(toks), dtype=torch.int32)
        toks = toks.to(model.device)
        logits, _ = model.forward(params, toks[:, :-1])
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, toks[:, 1:].long()[..., None])[..., 0]
        total_nll += float(nll.sum())
        total_tokens += int(toks.shape[0] * (toks.shape[1] - 1))
    if total_tokens == 0:
        raise ValueError("no evaluation tokens")
    mean_nll = total_nll / total_tokens
    return {"nll": mean_nll, "perplexity": math.exp(mean_nll),
            "tokens": total_tokens}
