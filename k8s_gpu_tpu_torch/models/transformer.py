"""Decoder-only transformer LM: the port of
``k8s_gpu_tpu/models/transformer.py`` for the dense serving model.

Parameters are a plain dict of tensors with the reference's layout and
names: layers stacked on a leading ``[L, ...]`` axis under ``"blocks"``,
so weights cross from the JAX package leaf for leaf (``convert.py``).  A
weight leaf is a tensor or the int8 serving form ``{"q": int8, "s": f32
scale}``.  The bf16 cast points are the reference's: for example
``_rmsnorm`` casts to ``x.dtype`` before multiplying by the scale.

Training runs through ``loss``: the same forward with gradients, causal
attention through ``ops.attention.flash_attention`` when ``use_flash``
(the CUDA kernels on the card), or ``flash_attention_v2`` when a flash-v2
knob is on (``flash_fuse_rope``, ``flash_kv_grouped`` with GQA,
``flash_q_pipeline`` > 1: rope in the kernels, K/V at their KV heads, P
query tiles per block).  Under ``remat`` each block is recomputed in the
backward.  ``remat_policy="full"`` checkpoints the whole block with
``torch.utils.checkpoint`` (the flash forward runs again, as under
``jax.checkpoint``).  ``"save_attn"`` runs each block as one
``autograd.Function`` that keeps the block's input, the attention's
output ``o`` [B, H, S, Dh] and its ``lse``, and recomputes the rest
around ``ops.attention.attention_replay``: one flash forward, one dq and
one dk/dv per layer and step, at about 2·B·S·D values and the lse a
layer.  (``torch.utils.checkpoint``'s selective policies cannot keep the
flash outputs: the kernels launch through ctypes, outside the
dispatcher the policy watches.)

With ``num_experts`` > 1 every block's MLP is the reference's Switch
top-1 MoE with capacity (``_moe_mlp``).  The reference dispatches with a
dense one-hot ``[G, E, cap]`` tensor; the port computes the same function
by index: tokens are copied into a static ``[E, cap + 1, D]`` buffer
whose last row a expert takes every dropped or masked token, the three
expert products run as batched matrix products over ``[E, cap, ...]``,
and each token gathers its expert's output back.  Shapes depend only on
the batch, never on the routing, and nothing on the path waits for the
card.

On a mesh (``forward``, ``forward_train`` and ``loss`` take ``mesh=``, a
``parallel.mesh`` mesh) the tokens are this rank's block [B/dp, S/sp].
With sp > 1 the attention is the reference's sequence-sharded path:
``sp_attention="ring"`` (``parallel/ring_attention.py``) or
``"ulysses"`` (``parallel/ulysses.py``), both through the flash kernels,
with rope outside at the block's **global** positions (rank r of sp
holds [r S/sp, (r+1) S/sp)); grouped K/V ride the ring at their KV
heads, and Ulysses keeps them grouped when ``ulysses_grouped_ok``
holds, else broadcasts them.  Where the reference mints
``flash_fallback_total`` at trace time on these paths (reason
``sp_fused_rope`` with ``flash_fuse_rope``, ``ulysses_kv_heads``), the
port has no trace: it counts each layer's attention each forward (the
kernels still run on both).  ``loss`` on a mesh is the block's own mean;
the ``Trainer`` averages it over the batch group (dp x sp).

With tp > 1 the parameters are this rank's shards (``parallel.sharding``)
and each block runs Megatron's layout of the reference's GSPMD program:
the normed input enters through ``copy_to``, q, k and v come from the
local ``wq``, ``wk``, ``wv`` (H/tp and KH/tp heads, through the same
flash kernels, ring or Ulysses), ``wo``'s product is a partial sum that
``reduce_from`` adds over tp, and the dense MLP is cut on F the same
way.  The vocabulary is cut too: the lookup takes the ids in this
rank's rows and sums over tp, the head gives this rank's logits
[B, S, V/tp] (what ``forward_train`` returns), ``loss`` takes a
vocab-parallel cross-entropy over them, and ``forward`` gathers them.

MoE on a mesh routes as the reference does on its global arrays: the
capacity is that of the microbatch's global token count, and a token's
slot counts the tokens routed to its expert before it in the global
row-major order, so each rank gathers the other blocks' per-row,
per-expert counts over the batch group; the aux loss takes global
means.  The batch is replicated over ep, as in the reference: each ep
rank runs its E/ep experts (and tp its F/tp slice of them) on its
block, and the selected outputs are summed over ep x tp before the
gate scales them.

With pp > 1 the blocks run as pipeline stages (``parallel/pipeline.py``):
``params["blocks"]`` holds this rank's stage (contiguous layers, or the
v chunks of interleaved 1F1B, ``virtual_stages``), each stage is the
rank's blocks through ``_block`` with the mesh (tp's collectives inside)
at positions ``arange(S)``, and the embedding and the head run outside
the pipeline on every pp rank.  ``forward`` and ``loss`` run GPipe's
forward schedule (full logits on every rank, aux 0);
``pipeline_value_and_grad`` runs 1F1B (or interleaved 1F1B) and returns
the gradients itself, the tail (final norm, head, cross-entropy; vocab
parallel on tp) fused into the last stage.  The pipeline composes with
dp and tp, not with MoE or sp (``_check_pp_composition``).

``save_attn`` runs on every mesh, as the reference's ``_remat_wrap``
does (one policy for the dense forward and the pipeline stage).  A
block keeps its input and what its attention made, and its backward
replays the rest of the block, its collectives included, in the same
order on every rank: on tp the one-device replay at the rank's heads
between ``copy_to`` and ``reduce_from``; on sp the ring's merged output
and lse of each zigzag half, whose backward rotates K/V once more
through the flash backward kernels (``ring_attention_replay``), or the
rank's heads' output and lse after Ulysses' all-to-all
(``ulysses_attention_replay``); with MoE the router, the slots and the
sums over ep x tp and over the batch group run again.  Under GPipe each
block of a stage is one ``_SaveAttnBlock``.  Under 1F1B the forward
tick keeps, beside the stage's input, each layer's attention output and
lse (``_pp_saving_fn``), and the backward tick recomputes the stage
with a graph around them (``_block_replay``): one flash forward a layer
and microbatch where full remat runs two, the backward pair as before.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import (
    attention_replay, flash_attention, flash_attention_lse,
    flash_attention_v2, flash_attention_v2_lse, reference_attention_lse,
)
from ..parallel.collectives import (
    all_gather, all_reduce, all_reduce_sum, copy_to, gather_from,
    reduce_from,
)
from ..parallel.mesh import axis_group, axis_rank, axis_size, batch_group
from ..parallel.pipeline import gpipe, interleaved_1f1b, one_f_one_b
from ..parallel.ring_attention import (
    ring_attention, ring_attention_replay, ring_attention_saving,
)
from ..parallel.ulysses import (
    ulysses_attention, ulysses_attention_replay, ulysses_attention_saving,
    ulysses_grouped_ok,
)
from ..utils.metrics import global_metrics


def wt(w, dt):
    """A weight leaf at compute dtype: plain tensors cast, int8 ``{q, s}``
    leaves dequantize (``q * s``) at ``dt``."""
    if isinstance(w, dict):
        return w["q"].to(dt) * w["s"].to(dt)
    return w.to(dt)


def emb_lookup(w, tokens, dt):
    """Embedding gather for plain or int8 tables — gather the int8 rows
    first, then scale by the gathered per-row scales."""
    tokens = tokens.long()
    if isinstance(w, dict):
        return w["q"][tokens].to(dt) * w["s"][tokens].to(dt)
    return w.to(dt)[tokens]


@dataclass(frozen=True)
class TransformerConfig:
    """The dense model's fields of the reference's config, same names and
    defaults."""
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_head: int = 64
    n_kv_heads: int = 0        # 0 = n_heads (plain multi-head attention)
    d_ff: int = 1376
    max_seq: int = 2048
    rope_theta: float = 10000.0
    # MoE: 0 or 1 = dense MLP; >1 = Switch top-1 MoE in every block, each
    # expert taking at most capacity_factor x its even share of tokens.
    num_experts: int = 0
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16
    # Recompute each block in the backward: "full" recomputes all of it,
    # "save_attn" keeps the attention's output and lse and recomputes the
    # rest (no second flash forward).
    remat: bool = True
    remat_policy: str = "full"
    # Flash attention (the CUDA kernels) in the training/eval forward;
    # 0 = the kernels' own tile (ops/attention.py:flash_plan).
    use_flash: bool = True
    flash_block_q: int = 0
    flash_block_k: int = 0
    # Flash-v2 knobs of the training path (ops/attention.py:
    # flash_attention_v2): rope applied in the kernels, K/V streamed at
    # their KV heads (with n_kv_heads < n_heads), and P > 1 query tiles per
    # block (0/1 = off).  On the card a P the kernels are not compiled for
    # raises.
    flash_fuse_rope: bool = False
    flash_kv_grouped: bool = False
    flash_q_pipeline: int = 0
    # The sequence-sharded attention on a mesh with sp > 1: "ring"
    # (ppermute streaming, any head count) or "ulysses" (all-to-all head
    # regrouping, heads divisible by sp).
    sp_attention: str = "ring"
    # The pipeline on a mesh with pp > 1: microbatches (0 = the
    # schedule's default: pp for gpipe, 2 pp for 1f1b when the batch
    # allows), the training schedule ("1f1b" or "gpipe"; forward-only
    # calls always take gpipe's forward) and the virtual stages a rank
    # holds under 1f1b (v > 1: interleaved 1F1B).
    pp_microbatches: int = 0
    pp_schedule: str = "1f1b"
    pp_virtual_stages: int = 1
    # Paged-KV attention read for serving: "gather" or "paged_kernel".
    attn_impl: str = "gather"

    @property
    def moe(self) -> bool:
        return self.num_experts > 1

    @property
    def kv_heads(self) -> int:
        kh = self.n_kv_heads or self.n_heads
        if self.n_heads % kh != 0:
            raise ValueError(
                f"n_heads {self.n_heads} must be a multiple of "
                f"n_kv_heads {kh}"
            )
        return kh


def layer_params(blocks: dict, layer: int) -> dict:
    """One layer's leaves (views) of the stacked ``[L, ...]`` blocks."""
    return {
        name: ({k: v[layer] for k, v in leaf.items()}
               if isinstance(leaf, dict) else leaf[layer])
        for name, leaf in blocks.items()
    }


class TransformerLM:
    def __init__(self, cfg: TransformerConfig, device="cuda"):
        if cfg.remat and cfg.remat_policy not in ("full", "save_attn"):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                             "expected 'full' or 'save_attn'")
        self.cfg = cfg
        self.device = resolve_device(device)
        half = cfg.d_head // 2
        self._freqs = cfg.rope_theta ** (
            -torch.arange(0, half, dtype=torch.float32, device=self.device)
            / half
        )

    # -- parameters --------------------------------------------------------
    def init(self, seed: int = 0, dtype=None) -> dict:
        """Random parameters with the reference's shapes and scales, drawn
        from a generator seeded with ``seed``, stored in ``dtype`` (default
        ``cfg.dtype``, what serving holds; the trainer asks for float32
        master weights, as the reference's ``init`` makes them).  Norm
        scales stay f32, as the reference keeps them, and so does the MoE
        router ``gate``, which routes in f32."""
        cfg = self.cfg
        dtype = cfg.dtype if dtype is None else dtype
        D, H, Dh, F, L, V = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
                             cfg.n_layers, cfg.vocab_size)
        KH = cfg.kv_heads
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def norm(shape, scale, dt=dtype):
            x = torch.randn(shape, generator=gen, device=self.device)
            return (x * scale).to(dt)

        def ones(shape):
            return torch.ones(shape, dtype=torch.float32, device=self.device)

        blocks = {
            "ln1": ones((L, D)),
            "ln2": ones((L, D)),
            "wq": norm((L, D, H, Dh), D ** -0.5),
            "wk": norm((L, D, KH, Dh), D ** -0.5),
            "wv": norm((L, D, KH, Dh), D ** -0.5),
            "wo": norm((L, H, Dh, D), (H * Dh) ** -0.5),
        }
        if cfg.moe:
            E = cfg.num_experts
            blocks["gate"] = norm((L, D, E), D ** -0.5, torch.float32)
            blocks["e_wi_gate"] = norm((L, E, D, F), D ** -0.5)
            blocks["e_wi_up"] = norm((L, E, D, F), D ** -0.5)
            blocks["e_wo"] = norm((L, E, F, D), F ** -0.5)
        else:
            blocks["wi_gate"] = norm((L, D, F), D ** -0.5)
            blocks["wi_up"] = norm((L, D, F), D ** -0.5)
            blocks["wo_mlp"] = norm((L, F, D), F ** -0.5)
        return {
            "embed": norm((V, D), 0.02),
            "final_norm": ones((D,)),
            "head": norm((D, V), D ** -0.5),
            "blocks": blocks,
        }

    def logical_axes(self) -> dict:
        """Same-shape tree of logical axis-name tuples (the "layers" axis
        maps to 'pp' stages when pipelining): the reference's table."""
        cfg = self.cfg
        axes = {
            "embed": ("vocab", "embed"),
            "final_norm": ("embed",),
            "head": ("embed", "vocab"),
            "blocks": {
                "ln1": ("stages", "embed"),
                "ln2": ("stages", "embed"),
                "wq": ("stages", "embed", "heads", "kv"),
                "wk": ("stages", "embed", "heads", "kv"),
                "wv": ("stages", "embed", "heads", "kv"),
                "wo": ("stages", "heads", "kv", "embed"),
            },
        }
        if cfg.moe:
            axes["blocks"]["gate"] = ("stages", "embed", None)
            axes["blocks"]["e_wi_gate"] = ("stages", "experts", "embed",
                                           "expert_mlp")
            axes["blocks"]["e_wi_up"] = ("stages", "experts", "embed",
                                         "expert_mlp")
            axes["blocks"]["e_wo"] = ("stages", "experts", "expert_mlp",
                                      "embed")
        else:
            axes["blocks"]["wi_gate"] = ("stages", "embed", "mlp")
            axes["blocks"]["wi_up"] = ("stages", "embed", "mlp")
            axes["blocks"]["wo_mlp"] = ("stages", "mlp", "embed")
        return axes

    # -- building blocks ---------------------------------------------------
    @staticmethod
    def _rmsnorm(x, scale):
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)

    def _rope(self, x, positions):
        """x [B, S, H, Dh]; ``positions`` [S] (shared across the batch) or
        [B, S] (per row)."""
        angles = positions[..., :, None].float() * self._freqs  # [..,S,half]
        if angles.ndim == 2:
            angles = angles[None]
        cos = torch.cos(angles)[:, :, None, :]                 # [1|B,S,1,half]
        sin = torch.sin(angles)[:, :, None, :]
        x1, x2 = x.float().chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return out.to(x.dtype)

    def _repeat_kv(self, t):
        """[B, KH, S, Dh] -> [B, H, S, Dh] for plain attention."""
        g = self.cfg.n_heads // self.cfg.kv_heads
        return t if g == 1 else t.repeat_interleave(g, dim=1)

    @staticmethod
    def _plain_causal_attention(q, k, v):
        """[B, H, S, Dh] causal attention in f32, output in q.dtype."""
        scale = q.shape[-1] ** -0.5
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)

    def _route(self, positions, mesh=None):
        """(v2, fused rope, grouped K/V) of the training attention.
        Flash-v2 derives rope positions from the tile it works on, so it
        takes only the dense arange positions of one unsplit sequence
        (never a block of a sequence sharded over sp)."""
        cfg = self.cfg
        grouped = self._grouped
        use_v2 = (cfg.use_flash and positions.ndim == 1
                  and axis_size(mesh, "sp") == 1
                  and (cfg.flash_fuse_rope or grouped
                       or cfg.flash_q_pipeline > 1))
        return use_v2, use_v2 and cfg.flash_fuse_rope, grouped

    @property
    def _grouped(self) -> bool:
        """``flash_kv_grouped`` with real groups (KH < H)."""
        cfg = self.cfg
        return cfg.flash_kv_grouped and cfg.n_heads // cfg.kv_heads > 1

    def _sp_grouped(self, mesh) -> bool:
        """Whether grouped K/V stay at their KV heads on the sp path: the
        ring takes them always, Ulysses when its all-to-all keeps each
        query head with its KV head."""
        cfg = self.cfg
        if self._grouped and cfg.sp_attention == "ulysses":
            return ulysses_grouped_ok(cfg.n_heads, cfg.kv_heads, mesh)
        return self._grouped

    def _qkv(self, x, lp, positions, mesh=None):
        """q [B, H, S, Dh] and k, v [B, H or KH, S, Dh] as the route's
        attention takes them."""
        dt = self.cfg.dtype
        use_v2, fuse_rope, grouped = self._route(positions, mesh)
        q = torch.einsum("bsd,dhk->bshk", x, wt(lp["wq"], dt))
        k = torch.einsum("bsd,dhk->bshk", x, wt(lp["wk"], dt))
        v = torch.einsum("bsd,dhk->bshk", x, wt(lp["wv"], dt))
        if not fuse_rope:
            q = self._rope(q, positions)
            k = self._rope(k, positions)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # [B,H,S,Dh]
        keep = (self._sp_grouped(mesh) if axis_size(mesh, "sp") > 1
                else use_v2 and grouped)
        if not keep:
            k, v = self._repeat_kv(k), self._repeat_kv(v)
        return q, k, v

    def _v2_args(self, positions) -> dict:
        cfg = self.cfg
        return dict(rope_theta=(cfg.rope_theta if self._route(positions)[1]
                                else None),
                    q_pipeline=max(1, cfg.flash_q_pipeline))

    def _out_proj(self, o, lp):
        o = o.transpose(1, 2)                                   # [B,S,H,Dh]
        return torch.einsum("bshk,hkd->bsd", o, wt(lp["wo"], self.cfg.dtype))

    def _attention(self, x, lp, positions, mesh=None):
        """Attention of the normed input ``x``; on a tp mesh over this
        rank's heads, summed over tp."""
        cfg = self.cfg
        tp = axis_group(mesh, "tp")
        q, k, v = self._qkv(copy_to(x, tp), lp, positions, mesh)
        blocks = dict(block_q=cfg.flash_block_q or None,
                      block_k=cfg.flash_block_k or None)
        if axis_size(mesh, "sp") > 1:
            sp_attend = {"ring": ring_attention,
                         "ulysses": ulysses_attention}[cfg.sp_attention]
            o = sp_attend(q, k, v, mesh, **blocks)
        elif self._route(positions)[0]:
            o = flash_attention_v2(q, k, v, causal=True,
                                   **self._v2_args(positions), **blocks)
        elif cfg.use_flash:
            o = flash_attention(q, k, v, causal=True, **blocks)
        else:
            o = self._plain_causal_attention(q, k, v)
        return reduce_from(self._out_proj(o, lp), tp)

    def _attention_lse(self, q, k, v, positions):
        """(o, lse) of the one-sequence training attention, for
        ``save_attn``."""
        cfg = self.cfg
        blocks = dict(block_q=cfg.flash_block_q or None,
                      block_k=cfg.flash_block_k or None)
        if self._route(positions)[0]:
            return flash_attention_v2_lse(q, k, v, causal=True,
                                          **self._v2_args(positions),
                                          **blocks)
        if cfg.use_flash:
            return flash_attention_lse(q, k, v, causal=True, **blocks)
        return reference_attention_lse(q, k, v, causal=True)

    def _dense_mlp(self, x, lp, mesh=None):
        """The dense MLP; on a tp mesh over this rank's F/tp, summed over
        tp."""
        dt = self.cfg.dtype
        tp = axis_group(mesh, "tp")
        x = copy_to(x, tp)
        g = torch.einsum("bsd,df->bsf", x, wt(lp["wi_gate"], dt))
        u = torch.einsum("bsd,df->bsf", x, wt(lp["wi_up"], dt))
        return reduce_from(torch.einsum(
            "bsf,fd->bsd", torch.nn.functional.silu(g) * u,
            wt(lp["wo_mlp"], dt),
        ), tp)

    def _moe_mlp(self, x, lp, full_capacity: bool = False,
                 token_mask=None, mesh=None, tp=None):
        """Switch top-1 MoE with capacity -> (y [B, S, D] at ``dt``, aux
        loss), the reference's function computed by index.

        The B·S tokens flatten in row-major order; each goes to the argmax
        of its router softmax (f32) and takes the next free slot of that
        expert, so when an expert's ``cap`` slots are full the latest
        tokens are dropped (y = 0; the residual carries them).
        ``full_capacity`` sizes every expert for all tokens (decode and
        verify: no request's output may depend on another's routing).
        ``token_mask`` [B, S] bool: False tokens (padding) take no slot
        and get y = 0, but still count in the aux loss's means, as in the
        reference.  y is the unrenormalised top-1 probability times the
        expert's output, in f32, cast once.  On a mesh, ``x`` is this
        rank's block and ``_moe_meshed`` routes it globally.  ``tp``: the
        serving engine's tp group, ``x`` whole on each of its ranks (the
        call's own tokens, routed alike everywhere): each rank runs its
        F slice of every expert and the outputs are summed over it."""
        if mesh is not None:
            return self._moe_meshed(x, lp, mesh)
        cfg = self.cfg
        dt = cfg.dtype
        B, S, D = x.shape
        E = cfg.num_experts
        G = B * S
        cap = G if full_capacity else max(1, int(cfg.capacity_factor * G / E))
        xt = x.reshape(G, D)
        probs, expert, onehot, gate = self._route_top1(xt, lp)
        if token_mask is not None:
            onehot = onehot * token_mask.reshape(1, G).float()
            gate = gate * token_mask.reshape(G).float()
        # Each token's slot: the tokens before it routed to its expert.
        pos = ((torch.cumsum(onehot, 1) - onehot) * onehot).sum(0).long()
        kept = (pos < cap) & (onehot.sum(0) > 0)
        # Dispatch: row cap of each expert is the dump of dropped and
        # masked tokens, sliced off before the products.
        slot = expert * (cap + 1) + torch.where(kept, pos, cap)
        buf = xt.new_zeros(E * (cap + 1), D).index_copy(0, slot, xt)
        out = self._experts(buf.view(E, cap + 1, D)[:, :cap], lp)
        # Combine: a dropped token reads some slot of its expert and
        # scales it by 0.
        back = reduce_from(out.reshape(E * cap, D).index_select(
            0, expert * cap + pos.clamp(max=cap - 1)), tp)
        y = back.float() * (gate * kept)[:, None]
        # Switch's load-balancing loss (eq. 4).
        aux = (onehot.mean(1) * probs.mean(0)).sum() * E
        return y.reshape(B, S, D).to(dt), aux

    def _route_top1(self, xt, lp):
        """The router over tokens [G, D]: (probs [G, E] f32, the argmax
        expert [G], its one-hot laid out [E, G], the top-1 probability
        [G])."""
        E = self.cfg.num_experts
        probs = torch.softmax(xt.float() @ lp["gate"].float(), dim=-1)
        expert = torch.argmax(probs, dim=-1)                      # [G]
        # The one-hot is [E, G], so the slot cumsum scans its inner axis
        # (on an H100 a scan down G = 49,152 rows of 4 columns took 4.3 ms
        # a call, 16 % of a training step).
        onehot = (torch.arange(E, device=xt.device)[:, None]
                  == expert).float()                              # [E, G]
        gate = probs.gather(-1, expert[:, None])[:, 0]            # [G]
        return probs, expert, onehot, gate

    def _experts(self, h, lp):
        """The experts' SwiGLU over their slots h [E, cap, D] (this
        rank's experts and F slice on a mesh)."""
        dt = self.cfg.dtype
        g = torch.bmm(h, wt(lp["e_wi_gate"], dt))
        u = torch.bmm(h, wt(lp["e_wi_up"], dt))
        return torch.bmm(torch.nn.functional.silu(g) * u, wt(lp["e_wo"], dt))

    def _global_slots(self, onehot, B, S, mesh):
        """Each token's slot in the microbatch's global row-major order
        [G_local] and the global token count.  The strided microbatches
        of ``make_train_step`` put the dp blocks' rows one after another
        and a row's sp blocks side by side, so a token's slot counts,
        for its expert, every token of the dp ranks before this one, of
        this dp rank's earlier rows (all their sp blocks), of the sp
        blocks before this one in its row, and of its own row before it:
        the per-row, per-expert counts of every block are gathered over
        the batch group (no gradient) and the exclusive prefix taken."""
        E = onehot.shape[0]
        rows = onehot.view(E, B, S)
        group = batch_group(mesh)
        dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
        counts = rows.sum(2).t().contiguous()                    # [B, E]
        c = torch.stack([counts] if group is None
                        else all_gather(counts, group))          # [dp*sp,B,E]
        c = c.view(dp, sp, B, E).permute(0, 2, 1, 3).reshape(-1, E)
        before = (torch.cumsum(c, 0) - c).view(dp, B, sp, E)
        offset = before[axis_rank(mesh, "dp"), :, axis_rank(mesh, "sp")]
        pos = torch.cumsum(rows, 2) - rows + offset.t()[:, :, None]
        return (pos * rows).sum(0).reshape(-1).long(), B * S * dp * sp

    def _moe_meshed(self, x, lp, mesh):
        """``_moe_mlp`` of this rank's block on a mesh, the reference's
        function of the global microbatch (``_global_slots``).  This rank
        runs its ep part of the experts, each with its tp part of F, on
        the block's kept tokens of those experts, packed in global order
        into ``min(cap, tokens)`` rows an expert; the partial outputs are
        summed over ep x tp (``reduce_from``) and then scaled by the
        gate, so the router's gradient is whole on every rank.  The aux
        loss's means are global: the block's sums are added over the
        batch group by ``all_reduce_sum``, whose backward sums each
        rank's share back (the ``Trainer`` averages the group's
        gradients)."""
        cfg = self.cfg
        dt = cfg.dtype
        B, S, D = x.shape
        E = cfg.num_experts
        xt = x.reshape(B * S, D)
        probs, expert, onehot, gate = self._route_top1(xt, lp)
        pos, G = self._global_slots(onehot, B, S, mesh)
        cap = max(1, int(cfg.capacity_factor * G / E))
        kept = pos < cap
        # This rank's experts, and each kept token's row among the
        # block's kept tokens of its expert (global order within a block
        # is its row-major order).
        El = lp["e_wi_gate"].shape[0]
        lo = axis_rank(mesh, "ep") * El
        mine = kept & (expert >= lo) & (expert < lo + El)
        own = onehot * mine.float()
        row = ((torch.cumsum(own, 1) - own) * own).sum(0).long()
        rows = min(cap, B * S)
        local = (expert - lo).clamp(0, El - 1)
        slot = local * (rows + 1) + torch.where(mine, row, rows)
        weights = axis_group(mesh, "ep", "tp")
        xe = copy_to(xt, weights)
        buf = xe.new_zeros(El * (rows + 1), D).index_copy(0, slot, xe)
        out = self._experts(buf.view(El, rows + 1, D)[:, :rows], lp)
        back = out.reshape(El * rows, D).index_select(
            0, local * rows + row.clamp(max=rows - 1))
        back = reduce_from(back * mine[:, None].to(back.dtype), weights)
        y = back.float() * (gate * kept)[:, None]
        sums = all_reduce_sum(torch.cat([onehot.sum(1), probs.sum(0)]),
                              batch_group(mesh))
        aux = (sums[:E] * sums[E:]).sum() / (G * G) * E
        return y.reshape(B, S, D).to(dt), aux

    def _mlp(self, x, lp, mesh=None):
        """The block's second half: (x + MLP(norm(x)), the MoE aux loss,
        or None for the dense MLP)."""
        h = self._rmsnorm(x, lp["ln2"])
        if self.cfg.moe:
            y, aux = (self._moe_mlp(h, lp) if mesh is None
                      else self._moe_mlp(h, lp, mesh=mesh))
            return x + y, aux
        return x + self._dense_mlp(h, lp, mesh), None

    def _block(self, x, lp, positions, mesh=None):
        """-> (x, aux or None)."""
        x = x + self._attention(self._rmsnorm(x, lp["ln1"]), lp, positions,
                                mesh)
        return self._mlp(x, lp, mesh)

    def _block_saving(self, x, lp, positions, mesh=None):
        """``_block`` without gradients -> (out, aux, kept): ``kept`` is
        what ``save_attn`` keeps of the attention, (o, lse) of this
        rank's heads, or on an sp mesh what the ring's or Ulysses'
        replay takes."""
        cfg = self.cfg
        tp = axis_group(mesh, "tp")
        q, k, v = self._qkv(copy_to(self._rmsnorm(x, lp["ln1"]), tp), lp,
                            positions, mesh)
        if axis_size(mesh, "sp") > 1:
            saving = {"ring": ring_attention_saving,
                      "ulysses": ulysses_attention_saving}[cfg.sp_attention]
            o, kept = saving(q, k, v, mesh,
                             block_q=cfg.flash_block_q or None,
                             block_k=cfg.flash_block_k or None)
        else:
            o, lse = self._attention_lse(q, k, v, positions)
            kept = (o, lse)
        x = x + reduce_from(self._out_proj(o, lp), tp)
        return (*self._mlp(x, lp, mesh), kept)

    def _block_replay(self, x, lp, positions, kept, mesh=None):
        """``_block`` recomputed around what ``_block_saving`` kept: the
        same operations and collectives, the attention by
        ``attention_replay`` (the ring's or Ulysses' replay on sp)."""
        cfg = self.cfg
        tp = axis_group(mesh, "tp")
        q, k, v = self._qkv(copy_to(self._rmsnorm(x, lp["ln1"]), tp), lp,
                            positions, mesh)
        if axis_size(mesh, "sp") > 1:
            replay = {"ring": ring_attention_replay,
                      "ulysses": ulysses_attention_replay}[cfg.sp_attention]
            o = replay(q, k, v, kept, mesh)
        else:
            use_v2 = self._route(positions)[0]
            o = attention_replay(
                q, k, v, *kept, causal=True, v2=use_v2,
                plain=not cfg.use_flash,
                **(self._v2_args(positions) if use_v2 else {}))
        x = x + reduce_from(self._out_proj(o, lp), tp)
        return self._mlp(x, lp, mesh)

    def _save_attn_block(self, x, lp, positions, mesh):
        """One block under ``save_attn`` with autograd -> (x, aux or
        None)."""
        names = sorted(lp)
        out = _SaveAttnBlock.apply(self, positions, mesh, names, x,
                                   *(lp[n] for n in names))
        return out if self.cfg.moe else (out, None)

    # -- forward -----------------------------------------------------------
    @torch.no_grad()
    def forward(self, params, tokens, mesh=None):
        """tokens [B, S] int -> (logits [B, S, V] f32, aux loss: the MoE
        layers' mean, 0 for the dense model), without gradients (serving,
        evaluation).  On a mesh, ``tokens`` is this rank's block, and on
        a tp mesh the ranks' vocabulary slices are gathered."""
        logits, aux = self.forward_train(params, tokens, mesh)
        return gather_from(logits, axis_group(mesh, "tp"), -1), aux

    def _check_mesh(self, mesh) -> None:
        """The reference's error for an unknown ``sp_attention``."""
        cfg = self.cfg
        if axis_size(mesh, "sp") > 1 and cfg.sp_attention not in (
                "ring", "ulysses"):
            raise ValueError(
                f"unknown sp_attention {cfg.sp_attention!r}; "
                "expected 'ring' or 'ulysses'")

    def _count_sp_fallbacks(self, mesh) -> None:
        """The reference's ``flash_fallback_total`` on the sp path, one a
        layer: rope kept outside the kernels, and Ulysses broadcasting
        grouped K/V its all-to-all cannot keep paired (counted from the
        local head counts KH/tp, as the reference does)."""
        cfg = self.cfg
        layers = float(cfg.n_layers)
        if cfg.flash_fuse_rope:
            global_metrics.inc("flash_fallback_total", layers,
                               reason="sp_fused_rope")
        if self._grouped and not self._sp_grouped(mesh):
            global_metrics.inc("flash_fallback_total", layers,
                               reason="ulysses_kv_heads")

    def _embed(self, w, tokens, mesh):
        """The embedding lookup; on a tp mesh this rank holds rows
        [r V/tp, (r+1) V/tp): it looks up the ids among them, zeroes the
        rest and sums over tp, where exactly one rank is non-zero."""
        tp = axis_group(mesh, "tp")
        if tp is None:
            return emb_lookup(w, tokens, self.cfg.dtype)
        rows = (w["q"] if isinstance(w, dict) else w).shape[0]
        t = tokens.long() - axis_rank(mesh, "tp") * rows
        inside = (t >= 0) & (t < rows)
        x = emb_lookup(w, torch.where(inside, t, 0), self.cfg.dtype)
        return reduce_from(x * inside[..., None].to(x.dtype), tp)

    def forward_train(self, params, tokens, mesh=None):
        """``forward`` with gradients: under grad mode each block is
        checkpointed when ``cfg.remat``.  The stacked ``[L, ...]`` leaves
        are split with ``unbind``, whose backward stacks the layers'
        gradients in one write.  On a mesh, ``tokens`` is this rank's
        block and rope takes its global positions; on a tp mesh the
        logits are this rank's vocabulary slice [B, S, V/tp]; on a pp
        mesh the blocks run GPipe's forward schedule."""
        cfg = self.cfg
        start = 0
        if mesh is not None:
            self._check_mesh(mesh)
            if axis_size(mesh, "pp") > 1:
                return self._forward_pipelined(params, tokens, mesh)
            start = axis_rank(mesh, "sp") * tokens.shape[1]
            if axis_size(mesh, "sp") > 1:
                self._count_sp_fallbacks(mesh)
        positions = torch.arange(start, start + tokens.shape[1],
                                 device=tokens.device)
        x = self._embed(params["embed"], tokens, mesh)
        layers = {name: ({k: v.unbind(0) for k, v in leaf.items()}
                         if isinstance(leaf, dict) else leaf.unbind(0))
                  for name, leaf in params["blocks"].items()}
        remat = cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), device=tokens.device)
        for layer in range(cfg.n_layers):
            lp = layer_params(layers, layer)
            if remat and cfg.remat_policy == "save_attn":
                x, a = self._save_attn_block(x, lp, positions, mesh)
            elif remat:
                x, a = checkpoint(self._block, x, lp, positions, mesh,
                                  use_reentrant=False)
            else:
                x, a = self._block(x, lp, positions, mesh)
            if a is not None:
                aux = aux + a
        return self._logits(params, x, mesh), aux / cfg.n_layers

    def _logits(self, params, x, mesh):
        """The final norm and the head: f32 logits (this rank's
        vocabulary slice on a tp mesh)."""
        x = copy_to(self._rmsnorm(x, params["final_norm"]),
                    axis_group(mesh, "tp"))
        logits = torch.einsum("bsd,dv->bsv", x,
                              wt(params["head"], self.cfg.dtype))
        return logits.float()

    @staticmethod
    def _nll(logits, targets, mesh):
        """-log softmax(logits)[target] per token; on a tp mesh the
        vocab-parallel cross-entropy over the ranks' slices."""
        tp = axis_group(mesh, "tp")
        if tp is None:
            logp = torch.log_softmax(logits, dim=-1)
            return -logp.gather(-1, targets.long()[..., None])[..., 0]
        return _vocab_parallel_nll(logits, targets, tp,
                                   axis_rank(mesh, "tp"))

    def loss(self, params, tokens, targets, mesh=None):
        """Next-token cross-entropy (mean) + 0.01 x the MoE aux loss (0 for
        the dense model), differentiable in ``params``.  On a mesh: the
        mean over this rank's block; on a tp mesh through the
        vocab-parallel cross-entropy."""
        logits, aux = self.forward_train(params, tokens, mesh)
        return self._nll(logits, targets, mesh).mean() + 0.01 * aux

    # -- the pipeline (pp > 1) ---------------------------------------------
    @property
    def virtual_stages(self) -> int:
        """The chunks a pp rank holds: ``pp_virtual_stages`` under 1f1b,
        one contiguous run of layers under gpipe."""
        cfg = self.cfg
        return cfg.pp_virtual_stages if cfg.pp_schedule == "1f1b" else 1

    def _pp_stage_fn(self, mesh, remat: bool):
        """One pipeline stage: ``_block`` over the leading axis of the
        given block leaves, with ``mesh`` (tp's collectives inside the
        stage) at positions ``arange(S)``; each block under the remat
        policy when ``remat`` (GPipe under autograd; 1F1B's backward tick
        is its own recompute).  ``kept``: what ``_pp_saving_fn`` kept of
        each layer's attention, which the blocks then replay around
        (1F1B's backward tick under ``save_attn``)."""
        save_attn = remat and self.cfg.remat_policy == "save_attn"

        def stage(blocks, x, kept=None):
            positions = torch.arange(x.shape[1], device=x.device)
            layers = {name: leaf.unbind(0) for name, leaf in blocks.items()}
            for layer in range(next(iter(blocks.values())).shape[0]):
                lp = layer_params(layers, layer)
                if kept is not None:
                    x, _ = self._block_replay(x, lp, positions, kept[layer],
                                              mesh)
                elif save_attn:
                    x, _ = self._save_attn_block(x, lp, positions, mesh)
                elif remat:
                    x, _ = checkpoint(self._block, x, lp, positions, mesh,
                                      use_reentrant=False)
                else:
                    x, _ = self._block(x, lp, positions, mesh)
            return x

        return stage

    def _pp_saving_fn(self, mesh):
        """1F1B's forward tick under ``save_attn``: the stage without a
        graph -> (its output, each layer's kept attention), which the
        backward tick's stage replays around."""
        @torch.no_grad()
        def saving(blocks, x):
            positions = torch.arange(x.shape[1], device=x.device)
            layers = {name: leaf.unbind(0) for name, leaf in blocks.items()}
            kept = []
            for layer in range(next(iter(blocks.values())).shape[0]):
                x, _, k = self._block_saving(
                    x, layer_params(layers, layer), positions, mesh)
                kept.append(k)
            return x, kept

        return saving

    def _check_pp_composition(self, mesh) -> None:
        """The pipeline composes with dp and tp only, with the reference's
        reasons: an MoE block's expert exchange would run on every
        microbatch tick against the pipeline ring, and ring attention's
        lockstep K/V rotation breaks under microbatching."""
        if self.cfg.moe:
            raise NotImplementedError(
                "MoE composes with ep/tp/dp, not pp — the per-block expert "
                "all-to-all would serialize against the pipeline ring "
                "(see _check_pp_composition docstring)"
            )
        if axis_size(mesh, "sp") > 1:
            raise NotImplementedError(
                "sequence parallelism composes with dp/tp, not pp — ring "
                "attention's lockstep K/V rotation breaks under "
                "microbatching (see _check_pp_composition docstring)"
            )

    def _forward_pipelined(self, params, tokens, mesh):
        """pp > 1: the blocks as GPipe stages, the embedding and the head
        outside the pipeline; full logits on every pp rank, aux 0."""
        cfg = self.cfg
        self._check_pp_composition(mesh)
        x = self._embed(params["embed"], tokens, mesh)
        stage = self._pp_stage_fn(mesh, cfg.remat and torch.is_grad_enabled())
        x = gpipe(stage, params["blocks"], x, mesh,
                  num_microbatches=cfg.pp_microbatches or None,
                  virtual_stages=self.virtual_stages)
        return (self._logits(params, x, mesh),
                torch.zeros((), device=tokens.device))

    def _embed_grad(self, w, tokens, dx, mesh):
        """The embedding's f32 gradient from the pipeline's input
        cotangent ``dx`` [B, S, D]: its scatter-add over the token ids
        (this rank's rows on a tp mesh; other ids add 0 to row 0)."""
        t = tokens.long()
        if axis_group(mesh, "tp") is not None:
            t = t - axis_rank(mesh, "tp") * w.shape[0]
        inside = (t >= 0) & (t < w.shape[0])
        rows = torch.where(inside, t, 0).reshape(-1)
        vals = (dx.float() * inside[..., None]).reshape(-1, dx.shape[-1])
        return torch.zeros(w.shape, dtype=torch.float32,
                           device=w.device).index_put_((rows,), vals,
                                                       accumulate=True)

    def pipeline_value_and_grad(self, params, tokens, targets, mesh):
        """(loss, gradients) of this rank's batch block through 1F1B, or
        interleaved 1F1B with ``pp_virtual_stages`` > 1: the gradients come
        from the schedule itself, not from autograd over the whole step.
        ``params`` are this rank's shards (the blocks in
        ``virtual_stages``' layout); the loss and the gradients of the
        leaves replicated over pp (embedding, final norm, head) are the
        same on every pp rank, the blocks' this stage's, all f32.  The
        tail is the final norm, the head and the cross-entropy fused into
        the last stage; the embedding's gradient is the scatter-add of
        the pipeline's input cotangent."""
        cfg = self.cfg
        self._check_mesh(mesh)
        self._check_pp_composition(mesh)
        with torch.no_grad():
            x = self._embed(params["embed"], tokens, mesh)

        def tail_loss_fn(tail, y, tgt):
            logits = self._logits({"final_norm": tail[0], "head": tail[1]},
                                  y, mesh)
            return self._nll(logits, tgt, mesh).mean()

        args = (self._pp_stage_fn(mesh, False), params["blocks"],
                (params["final_norm"], params["head"]), tail_loss_fn, x,
                targets, mesh)
        kw = dict(num_microbatches=cfg.pp_microbatches or None,
                  saving_fn=(self._pp_saving_fn(mesh) if cfg.remat
                             and cfg.remat_policy == "save_attn" else None))
        if self.virtual_stages > 1:
            loss, dblocks, (dnorm, dhead), dx = interleaved_1f1b(
                *args, v=self.virtual_stages, **kw)
        else:
            loss, dblocks, (dnorm, dhead), dx = one_f_one_b(*args, **kw)
        return loss, {"embed": self._embed_grad(params["embed"], tokens, dx,
                                                mesh),
                      "final_norm": dnorm, "head": dhead, "blocks": dblocks}


def _vocab_parallel_nll(logits, targets, group, rank: int):
    """-log softmax(logits)[target] from this rank's vocabulary slice
    [B, S, V/tp] in f32, without the whole [B, S, V] on any rank: the row
    max over tp (no gradient), then the sum of exponentials and the
    target's shifted logit (non-zero on the rank that holds it), summed
    over tp in one all-reduce whose backward hands each rank its own
    part.  The reference's ``log_softmax`` and ``take_along_axis``."""
    rows = logits.shape[-1]
    m = all_reduce(logits.detach().amax(-1), group,
                   op=torch.distributed.ReduceOp.MAX)
    z = logits - m[..., None]
    t = targets.long() - rank * rows
    inside = (t >= 0) & (t < rows)
    zt = z.gather(-1, torch.where(inside, t, 0)[..., None])[..., 0]
    parts = reduce_from(torch.stack([z.exp().sum(-1), zt * inside]), group)
    return torch.log(parts[0]) - parts[1]


class _SaveAttnBlock(torch.autograd.Function):
    """One block under ``remat_policy="save_attn"``: the forward runs
    without a graph and keeps the block's input and what its attention
    made (``_block_saving``); the backward recomputes the block around
    them (``_block_replay``, the mesh's collectives included) and
    differentiates that.  Inputs: the model, the positions, the mesh, the
    layer's leaf names, x and the leaves.  Output: the block's output,
    and for an MoE model also its aux loss, whose gradient reaches the
    router through the backward."""

    @staticmethod
    def forward(ctx, model, positions, mesh, names, x, *leaves):
        out, aux, kept = model._block_saving(x, dict(zip(names, leaves)),
                                             positions, mesh)
        ctx.model, ctx.mesh, ctx.names = model, mesh, names
        ctx.n_kept = len(kept)
        ctx.save_for_backward(x, positions, *kept, *leaves)
        return out if aux is None else (out, aux)

    @staticmethod
    def backward(ctx, *g_outs):
        x, positions, *rest = ctx.saved_tensors
        kept, leaves = tuple(rest[:ctx.n_kept]), rest[ctx.n_kept:]
        needs = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip((x, *leaves), needs)]
            out, aux = ctx.model._block_replay(
                inputs[0], dict(zip(ctx.names, inputs[1:])), positions,
                kept, ctx.mesh)
        outs = (out,) if aux is None else (out, aux)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, wanted, g_outs))
        return (None, None, None, None,
                *(next(grads) if t.requires_grad else None for t in inputs))
