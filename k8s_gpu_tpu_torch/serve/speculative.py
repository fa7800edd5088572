"""Speculative decoding math and draft distillation: the port of
``k8s_gpu_tpu/serve/speculative.py``.

The continuous batcher's spec rounds (``executor._round_spec_dev`` and
``_round_spec_ngram_dev``) are the one speculative surface; this module
holds what they ride on: the accept/correct math (``reject_row``,
``rejection_sample``), the shared sampling warp (``warped_probs``), the
int8 draft (``int8_draft``) and draft training (``distill_draft``).

- A draft proposes K tokens; the target scores the window [token, g] in
  one ``extend_multi`` (query length K + 1), and the accepted prefix plus
  the target's correction or bonus token are emitted.
- Greedy rows (temperature 0) emit target argmaxes only: the stream is
  the plain stream whatever the draft proposes.
- Sampled rows run Leviathan rejection sampling: accept draft i with
  probability min(1, p_i(g_i) / q_i(g_i)), else emit from the normalized
  residual max(p - q, 0).  The emitted distribution is the target's for
  any draft.  Draws come from a ``torch.Generator`` a row, so a seeded
  row's draws never depend on its co-tenants (the reference splits a
  ``jax.random`` key a row; its draws are not reproduced, only their
  distribution).
- Rejected drafts leave stale K/V past the accepted frontier; masks
  never read past a row's position and the next window overwrites them.
- The draft stays one position behind the target and re-ingests ``prev``
  each sub-round, which makes the all-accepted case uniform.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .engine import InferenceEngine, SamplingConfig


def warped_probs(logits, sampling: SamplingConfig):
    """The sampling distribution as probabilities: the softmax of the
    warp ``InferenceEngine._sample`` draws from."""
    return torch.softmax(InferenceEngine.warp_logits(logits, sampling),
                         dim=-1)


def residual(p, q, a: int):
    """The distribution a row's correction is drawn from after ``a``
    accepted drafts: the normalized max(p_a - q_a, 0), with q extended by
    a zero row (the all-accepted bonus is then p_K), or p_a itself where
    the residual's mass is at float noise (norm <= 1e-9).  p [K+1, V], q
    [K, V]."""
    q_a = q[a] if a < q.shape[0] else torch.zeros_like(p[a])
    res = (p[a] - q_a).clamp_min(0.0)
    norm = res.sum()
    if float(norm) > 1e-9:
        return res / norm.clamp_min(1e-30)
    return p[a]


def reject_row(p, q, g, generator=None, *, uniforms=None, gumbel=None):
    """One row of speculative rejection sampling, the one implementation
    of the accept/residual math.

    p [K+1, V]: warped target distributions at each verify position;
    q [K, V]: the warped draft distributions the drafts came from; g [K]:
    the drafts.  Returns (a, x): the number of leading drafts accepted
    (an int) and the correction token (a 0-d int32 tensor) drawn from
    ``residual(p, q, a)``.

    The strict test ``u * q(g) < p(g)`` is u < p/q without the divide.
    ``uniforms`` [K] and ``gumbel`` [V] replace the draws from
    ``generator`` (K uniforms, then V Gumbel variates for the categorical
    draw ``argmax(log(dist + 1e-30) + gumbel)``): the seam that holds
    this function against the reference on the reference's own draws."""
    K = g.shape[0]
    gl = g.long()
    p_at_g = p[:K].gather(1, gl[:, None])[:, 0]
    q_at_g = q.gather(1, gl[:, None])[:, 0]
    if uniforms is None:
        uniforms = torch.rand(K, generator=generator, device=p.device)
    accept = uniforms.to(p.device) * q_at_g < p_at_g
    a = int(torch.cumprod(accept.int(), 0).sum())
    dist = residual(p, q, a)
    if gumbel is None:
        u = torch.rand(dist.shape, generator=generator, device=p.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    x = torch.argmax(torch.log(dist + 1e-30) + gumbel.to(p.device))
    return a, x.to(torch.int32)


def rejection_sample(p, q, g, generators):
    """Batched rejection sampling, a generator a row.  p [B, K+1, V], q
    [B, K, V], g [B, K] -> (a [B], x [B]) int32."""
    pairs = [reject_row(p[b], q[b], g[b], generators[b])
             for b in range(g.shape[0])]
    a = torch.tensor([n for n, _ in pairs], dtype=torch.int32,
                     device=g.device)
    return a, torch.stack([x for _, x in pairs])


def int8_draft(draft_params, logical_axes=None, mesh=None):
    """A draft param tree for int8 compute (``draft_int8=True``): weights
    int8 with per-channel scales, consumed by an
    ``InferenceEngine(int8_compute=True)``.  Safe for the draft only:
    the acceptance test is exact for any q, so quantization moves the
    acceptance rate, never the stream; the target keeps its dtype.  On a
    mesh ``draft_params`` are this rank's shards (cut by
    ``logical_axes``): they are gathered, the whole draft is quantized,
    and it is cut again (``quant.shard_quantized``), so every rank holds
    the scales of the whole tree."""
    from .quant import quantize_params, shard_quantized

    if mesh is None:
        return quantize_params(draft_params)
    from ..parallel.sharding import gather_params

    whole = gather_params(draft_params, logical_axes, mesh)
    return shard_quantized(quantize_params(whole), logical_axes, mesh)


def distill_draft(target_model, tparams, draft_cfg=None, *, steps: int = 200,
                  batch: int = 8, seq_len: int = 64, lr: float = 3e-3,
                  seed: int = 0, data_temperature: float = 1.0,
                  hard_labels: bool = False, prompts=None, train_dtype=None,
                  target_agreement: float = 0.0, init_params=None,
                  stats: dict | None = None):
    """Distill a small draft LM from a target, on the target's own
    samples: ancestral sequences at ``data_temperature`` from ``prompts``
    [B, P] (or random 2-token prompts, ``batch`` of them).

    - ``hard_labels=False``: KL(p_target || p_draft), what sampled spec
      rewards;
    - ``hard_labels=True`` with ``data_temperature=0``: cross-entropy
      against the target's argmax on its greedy trajectories, what greedy
      spec accepts on.

    ``train_dtype``: the draft's compute type (its master weights are
    f32).  ``target_agreement`` > 0: stop once the draft's argmax agrees
    with the labels at this rate (checked every 25 steps, hard labels
    only).  The optimizer is optax's ``adamw`` (b2 0.999, weight decay
    1e-4, no clipping) on a warmup-cosine schedule, written out in torch
    (``train.runner.AdamW``).  ``draft_cfg`` defaults to the target at 2
    layers and half width.  ``init_params``: the draft's initial
    parameters (else ``init(seed)``).  ``stats``: a dict that receives
    the steps taken, the last agreement read and the training sequences
    (a list of token lists).  Returns (draft_model,
    dparams, final_loss); on the card the draft trains through the flash
    kernels when its config says ``use_flash``."""
    from ..models import TransformerLM
    from ..train.runner import AdamW, TrainConfig, tree_leaves, tree_map

    cfg = target_model.cfg
    device = target_model.device
    if draft_cfg is None:
        draft_cfg = dataclasses.replace(
            cfg, n_layers=2, d_model=max(32, cfg.d_model // 2),
            d_ff=max(64, cfg.d_ff // 2), num_experts=0,
        )
    if train_dtype is not None:
        draft_cfg = dataclasses.replace(draft_cfg, dtype=train_dtype)
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError("draft_cfg must keep the target's vocab_size")
    draft_model = TransformerLM(draft_cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if prompts is None:
        prompts = torch.randint(1, cfg.vocab_size, (batch, 2),
                                generator=gen, device=device)
    prompts = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    P = prompts.shape[1]
    if P >= seq_len:
        raise ValueError(f"prompts ({P}) must be shorter than seq_len "
                         f"({seq_len})")
    with torch.no_grad():
        eng = InferenceEngine(target_model, max_seq=max(seq_len + 4, 16),
                              device=device)
        out = eng.generate(
            tparams, prompts, max_new_tokens=seq_len - P,
            sampling=SamplingConfig(temperature=data_temperature),
            seed=seed + 1,
        )
        seqs = torch.cat([prompts, out.tokens.long()], dim=1)
        tlogits, _ = target_model.forward(tparams, seqs)
        if hard_labels:
            labels = torch.argmax(tlogits, dim=-1)
        else:
            pt = torch.softmax(tlogits.float(), dim=-1)
            lp = torch.log_softmax(tlogits.float(), dim=-1)
        del tlogits

    if init_params is None:
        init_params = draft_model.init(seed, dtype=torch.float32)
    dparams = tree_map(
        lambda t: t.detach().to(device, torch.float32).clone()
        .requires_grad_(True), init_params)
    leaves = tree_leaves(dparams)
    warm = max(1, steps // 20)
    tc = TrainConfig(learning_rate=lr, weight_decay=1e-4,
                     grad_clip=math.inf, b1=0.9, b2=0.999,
                     schedule="cosine", warmup_steps=warm,
                     decay_steps=max(2, steps) - warm, min_lr_frac=0.01)
    opt = AdamW(tc, leaves)

    def loss_fn():
        dlogits, _ = draft_model.forward_train(dparams, seqs)
        lq = torch.log_softmax(dlogits.float(), dim=-1)
        if hard_labels:
            return -lq.gather(-1, labels[..., None]).mean()
        return (pt * (lp - lq)).sum(-1).mean()

    loss = torch.tensor(math.inf)
    taken, agree = 0, None
    for i in range(steps):
        taken = i + 1
        with torch.enable_grad():
            loss = loss_fn()
            grads = torch.autograd.grad(loss, leaves)
        opt.update(leaves, grads)
        if (hard_labels and target_agreement > 0.0 and i % 25 == 24):
            with torch.no_grad():
                dlogits, _ = draft_model.forward(dparams, seqs)
                agree = float((torch.argmax(dlogits, -1) == labels)
                              .float().mean())
            if agree >= target_agreement:
                break
    if stats is not None:
        stats.update(steps=taken, agreement=agree,
                     sequences=seqs.tolist())
    dparams = tree_map(lambda t: t.detach(), dparams)
    return draft_model, dparams, float(loss.detach())
