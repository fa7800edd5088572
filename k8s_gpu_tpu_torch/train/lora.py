"""LoRA fine-tuning: the port of ``k8s_gpu_tpu/train/lora.py``.

Adapters are a separate tree beside frozen base parameters: for each
adapted leaf an ``a`` [.., fin, R] and a ``b`` [.., R, fout] (the leading
layer axis of ``"blocks"`` leaves kept), where fin and fout flatten the
base weight's input and output dims.  ``LoraAdapter.merge`` builds
``W + scale * (A @ B)`` functionally inside the loss, so autograd reaches
only the adapter leaves, through the same forward (flash attention
kernels included) as the base model's own training step.

``LoraModel`` is a drop-in model for ``train.Trainer``: ``init(seed,
dtype)`` makes the adapter tree from an explicit ``torch.Generator`` on
the base model's device, and ``loss`` differentiates the adapters only.

On a mesh the adapters are cut by their logical axes (the reference's
``logical_axes``: each inherits its base leaf's axes, ``"stages"``
included) and the base by the model's: ``loss`` merges this rank's
shards.  The half of an adapter that tp leaves whole (A of a leaf cut on
its output, B of one cut on its input) enters the merge through
``copy_to``, so its gradient is summed over the tp ranks whose slices it
fed, as GSPMD sums it in the reference.  On a pp mesh a rank holds its
stage's adapters, and the model has no 1F1B of its own, so the
``Trainer`` trains it through the base model's GPipe forward, as the
reference's does; on ep the base's experts are cut and the adapters
(on the attention and dense leaves) are whole.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..parallel.collectives import copy_to
from ..parallel.mesh import axis_group
from ..parallel.sharding import ParamRules, cut_axes, shard_params

# For each adaptable leaf under "blocks": how many dims after the leading
# layer axis are the matmul's input.  wq (L, D, H, Dh) maps D -> H*Dh, wo
# (L, H, Dh, D) maps H*Dh -> D.
_BLOCK_TARGETS: dict[str, int] = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 2,
    "wi_gate": 1, "wi_up": 1, "wo_mlp": 1,
}
# Top-level leaves: input dims, no layer axis.
_TOP_TARGETS: dict[str, int] = {"head": 1}


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # Leaves that get adapters; the default is the attention projections.
    targets: tuple = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _split_dims(name: str, shape: tuple, in_blocks: bool) -> tuple | None:
    """(batch_dims, in_dims, out_dims) of an adaptable leaf, else None."""
    table = _BLOCK_TARGETS if in_blocks else _TOP_TARGETS
    n_in = table.get(name)
    if n_in is None:
        return None
    if in_blocks:
        return shape[:1], shape[1:1 + n_in], shape[1 + n_in:]
    return (), shape[:n_in], shape[n_in:]


def _shape(w) -> tuple:
    return tuple((w["q"] if isinstance(w, dict) else w).shape)


def _device_of(tree: dict) -> torch.device:
    leaf = tree["blocks"]["wq"]
    return (leaf["q"] if isinstance(leaf, dict) else leaf).device


class LoraAdapter:
    """Builds and merges adapters for a ``TransformerLM``-shaped tree."""

    def __init__(self, cfg: LoraConfig):
        self.cfg = cfg

    def init(self, seed: int, base_params: dict,
             dtype=torch.float32) -> dict:
        """A ~ N(0, 0.02) and B = 0, so the delta starts at exactly zero
        and step 0 of fine-tuning reproduces the base model.  Drawn from
        a generator seeded with ``seed`` on the base parameters' device,
        target by target in the base tree's order."""
        r = self.cfg.rank
        dev = _device_of(base_params)
        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def pair(batch, fin, fout):
            a = torch.randn((*batch, fin, r), generator=gen, device=dev)
            return {"a": (a * 0.02).to(dtype),
                    "b": torch.zeros((*batch, r, fout), dtype=dtype,
                                     device=dev)}

        out: dict = {"blocks": {}}
        for name, w in base_params["blocks"].items():
            dims = _split_dims(name, _shape(w), in_blocks=True)
            if dims is None or name not in self.cfg.targets:
                continue
            batch, din, dout = dims
            out["blocks"][name] = pair(batch, math.prod(din),
                                       math.prod(dout))
        for name, w in base_params.items():
            if name == "blocks" or not isinstance(w, (torch.Tensor, dict)):
                continue
            dims = _split_dims(name, _shape(w), in_blocks=False)
            if dims is None or name not in self.cfg.targets:
                continue
            _, din, dout = dims
            out[name] = pair((), math.prod(din), math.prod(dout))
        if not out["blocks"] and len(out) == 1:
            raise ValueError(f"no adaptable targets among {self.cfg.targets}")
        return out

    def logical_axes(self, base_axes: dict) -> dict:
        """A inherits the base leaf's input axes (flattened to the first),
        B its output axes; the rank axis is 'lora' (replicated)."""
        out: dict = {"blocks": {}}
        for name, axes in base_axes["blocks"].items():
            if name not in self.cfg.targets or name not in _BLOCK_TARGETS:
                continue
            n_in = _BLOCK_TARGETS[name]
            out["blocks"][name] = {
                "a": (axes[0], axes[1], "lora"),
                "b": (axes[0], "lora", axes[1 + n_in]),
            }
        for name, axes in base_axes.items():
            if name == "blocks" or not isinstance(axes, tuple):
                continue
            if name not in self.cfg.targets or name not in _TOP_TARGETS:
                continue
            n_in = _TOP_TARGETS[name]
            out[name] = {"a": (axes[0], "lora"), "b": ("lora", axes[n_in])}
        return out

    def merge(self, base_params: dict, lora_params: dict,
              whole: dict | None = None) -> dict:
        """base + scale * (A @ B), reshaped to each leaf's shape and cast
        to its dtype.  Functional: returns a new tree, base untouched.
        ``whole``: {(target, half): tp group} of the halves a tp mesh
        leaves whole beside a cut partner, taken through ``copy_to``."""
        scale = self.cfg.scale
        whole = whole or {}

        def halves(name, ab):
            return [copy_to(ab[h], whole[(name, h)]) if (name, h) in whole
                    else ab[h] for h in ("a", "b")]

        merged = dict(base_params)
        merged["blocks"] = dict(base_params["blocks"])
        for name, ab in lora_params.get("blocks", {}).items():
            w = base_params["blocks"][name]
            a, b = halves(name, ab)
            delta = torch.einsum("lir,lro->lio", a, b) * scale
            merged["blocks"][name] = w + delta.reshape(w.shape).to(w.dtype)
        for name, ab in lora_params.items():
            if name == "blocks":
                continue
            w = base_params[name]
            a, b = halves(name, ab)
            delta = (a @ b) * scale
            merged[name] = w + delta.reshape(w.shape).to(w.dtype)
        return merged


class LoraModel:
    """A ``Trainer``-compatible view of a frozen base model: ``init``
    makes adapter parameters, ``loss`` differentiates the adapters only
    (the base leaves never take a gradient and stay bit-identical).
    ``Trainer(LoraModel(model, base_params), device=...)`` fine-tunes,
    on a mesh too (``loss`` takes ``mesh=``).  ``base_params`` is the
    whole tree; on a mesh that cuts it ``loss`` takes this rank's shards
    of it, cut once a mesh."""

    def __init__(self, model, base_params: dict,
                 cfg: LoraConfig | None = None):
        self.model = model
        self.device = model.device
        self.base_params = base_params
        self.cfg = cfg or LoraConfig()
        self.adapter = LoraAdapter(self.cfg)
        self._meshed: dict = {}

    def init(self, seed: int = 0, dtype=torch.float32) -> dict:
        return self.adapter.init(seed, self.base_params, dtype)

    def logical_axes(self) -> dict:
        return self.adapter.logical_axes(self.model.logical_axes())

    @property
    def virtual_stages(self) -> int:
        """The base model's stage layout on a pp mesh, which the
        adapters' ``"stages"`` cut follows."""
        return getattr(self.model, "virtual_stages", 1)

    def _on_mesh(self, mesh) -> tuple:
        """(this rank's base shards, the adapter halves ``merge`` takes
        through ``copy_to``) on ``mesh``, made once a mesh."""
        key = id(mesh)
        if key not in self._meshed:
            rules, tp = ParamRules(), axis_group(mesh, "tp")

            def on_tp(axes) -> bool:
                return any(a == "tp" for _, a in
                           cut_axes(rules.spec(axes), mesh))

            whole = {}
            for top, axes in self.logical_axes().items():
                for name, ab in (axes.items() if top == "blocks"
                                 else [(top, axes)]):
                    for h, other in (("a", "b"), ("b", "a")):
                        if (tp is not None and not on_tp(ab[h])
                                and on_tp(ab[other])):
                            whole[(name, h)] = tp
            self._meshed[key] = (
                shard_params(self.base_params, self.model.logical_axes(),
                             mesh, virtual_stages=self.virtual_stages),
                whole)
        return self._meshed[key]

    def loss(self, lora_params, tokens, targets, mesh=None):
        if mesh is None:
            merged = self.adapter.merge(self.base_params, lora_params)
        else:
            base, whole = self._on_mesh(mesh)
            merged = self.adapter.merge(base, lora_params, whole)
        return self.model.loss(merged, tokens, targets, mesh=mesh)

    @torch.no_grad()
    def merged_params(self, lora_params) -> dict:
        """Bake the adapters in (for serving or export)."""
        return self.adapter.merge(self.base_params, lora_params)


def num_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(num_params(v) for v in tree.values())
    return int(tree.numel())
