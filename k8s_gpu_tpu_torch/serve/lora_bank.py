"""Multi-LoRA serving, the port of ``k8s_gpu_tpu/serve/lora_bank.py``: a
bank of adapters, one batched decode.

Every adapter is stacked into per-layer tensors on the batcher's device,
so one decode step serves the base model and every adapter at once, each
row gathering its own adapter by index:

- leaves are stacked ``[L, K+1, fin, R]`` / ``[L, K+1, R, fout]`` (the
  engine's layer loop slices the leading layer axis);
- index 0 is the base "adapter", exact zeros, so a base row computes
  ``x@W + (x@0)@0``: bitwise the un-adapted step;
- ranks zero-pad to the bank's largest (padding adds exactly zero);
- each adapter's scale is folded into its B half in float32 when the
  bank is built (``scale·(xA)B = (xA)(scale·B)``), before any cast.

The delta is two batched products (``torch.bmm``), as the reference's
are ``jnp.einsum`` calls outside any kernel.

On a serving mesh (``mesh=``) the bank holds this rank's slices, cut by
the adapters' logical axes (``LoraAdapter.logical_axes``, the
reference's): A takes the base leaf's input axes, B its output axes, the
rank axis stays whole.  For ``wq``, ``wk`` and ``wv`` B is cut on the
heads, so each rank's delta lands on its own heads; for ``wo`` A is cut
on its input, so each rank adds its partial ``(o A) B`` before the tp
sum of ``wo``'s product.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# Targets the engine serves: the attention projections.
SERVABLE_TARGETS = ("wq", "wk", "wv", "wo")


def _f32(x) -> np.ndarray:
    """A host float32 array of an adapter leaf (tensor or array)."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _tensors(tree):
    """An adapter tree with every leaf a host tensor (arrays converted)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return tree if torch.is_tensor(tree) else torch.from_numpy(_f32(tree))


class AdapterBank:
    """``names[0]`` is always ``"__base__"`` (the zero adapter)."""

    def __init__(self, adapters: dict, device="cuda", mesh=None,
                 base_axes: dict | None = None):
        """``adapters``: name -> (lora params from ``LoraAdapter.init``,
        its ``LoraConfig``), leaves as tensors or arrays, whole.  Only
        the attention projections are banked; an adapter carrying
        another target is refused rather than served as a different
        model than was trained.  ``mesh`` and ``base_axes`` (the base
        model's ``logical_axes()``): keep this rank's slices (module
        docstring)."""
        self.device = resolve_device(device)
        self.names = ["__base__"] + sorted(adapters)
        for name, (tree, _) in adapters.items():
            extra = [
                t for t in tree.get("blocks", {}) if t not in SERVABLE_TARGETS
            ] + [t for t in tree if t != "blocks"]
            if extra:
                raise ValueError(
                    f"adapter {name!r} adapts {extra}; the serving bank "
                    f"supports {SERVABLE_TARGETS} only"
                )
        if not adapters:
            self.banked = None
            return
        if mesh is not None:
            from ..parallel.sharding import shard_params
            from ..train.lora import LoraAdapter

            adapters = {
                name: (shard_params(_tensors(tree),
                                    LoraAdapter(cfg).logical_axes(base_axes),
                                    mesh), cfg)
                for name, (tree, cfg) in adapters.items()}
        ranks = {
            name: next(iter(tree["blocks"].values()))["a"].shape[-1]
            for name, (tree, _) in adapters.items()
        }
        R = max(ranks.values())
        # Leaf shapes come from whichever adapter carries each target.
        shapes = {}
        for name, (tree, _) in adapters.items():
            for t, ab in tree["blocks"].items():
                L, fin, _ = ab["a"].shape
                fout = ab["b"].shape[-1]
                shapes[t] = (L, fin, fout)
        K = len(self.names)
        banked = {}
        for t, (L, fin, fout) in shapes.items():
            a = np.zeros((L, K, fin, R), np.float32)
            b = np.zeros((L, K, R, fout), np.float32)
            for i, name in enumerate(self.names[1:], start=1):
                tree, cfg = adapters[name]
                ab = tree["blocks"].get(t)
                if ab is None:
                    continue
                r = ab["a"].shape[-1]
                a[:, i, :, :r] = _f32(ab["a"])
                b[:, i, :r, :] = _f32(ab["b"]) * cfg.scale
            banked[t] = {"a": torch.from_numpy(a).to(self.device),
                         "b": torch.from_numpy(b).to(self.device)}
        self.banked = banked

    def index(self, name: str | None) -> int:
        if name is None:
            return 0
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown adapter {name!r}; serving {self.names[1:]}"
            ) from None


def layer_slice(banked: dict | None, layer: int) -> dict | None:
    """One layer's bank, {target: {"a": [K, fin, R], "b": [K, R, fout]}}
    (views), or None without a bank."""
    if banked is None:
        return None
    return {t: {"a": ab["a"][layer], "b": ab["b"][layer]}
            for t, ab in banked.items()}


def lora_delta(inp, ad, idx, dt):
    """Per-row low-rank correction of one layer's target.

    ``inp`` [B, S, fin] (the activation the base product takes, flattened
    on its input dims); ``ad`` {"a": [K, fin, R], "b": [K, R, fout]}
    (this layer's bank); ``idx`` [B] the adapter of each row.  Returns
    [B, S, fout] in ``dt``."""
    a = ad["a"][idx.long()].to(dt)     # [B, fin, R]
    b = ad["b"][idx.long()].to(dt)     # [B, R, fout]
    return torch.bmm(torch.bmm(inp, a), b)
