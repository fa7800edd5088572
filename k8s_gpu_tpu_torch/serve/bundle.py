"""Servable model bundles, the export -> serve half of the model
lifecycle: the port of ``k8s_gpu_tpu/serve/bundle.py``, in the
reference's format, so either package loads what the other wrote.

A bundle is a self-describing directory:

    config.json     {"format": "k8s-gpu-tpu-servable-v1", "model":
                     "TransformerLM", "config": TransformerConfig fields,
                     "leaves": {path: {"dtype", "shape"}}, "tokenizer"}
    params.npz      every parameter leaf, path-keyed ("blocks/wq", ...)
    tokenizer.json  optional BPE merges

Int8 ``{q, s}`` leaves flatten as ``.../q`` and ``.../s``, so an exported
int8 model loads as int8 (its matmul leaves laid out as
``quantize_params`` lays them, for ``int8_compute``).  bfloat16
leaves ride the npz as 2-byte void records (numpy has no bfloat16): the
port views those bytes as 16-bit integers and then as ``torch.bfloat16``,
and writes the same ``|V2`` records, which the reference views back.

The pipeline fields (``pp_microbatches``, ``pp_schedule``,
``pp_virtual_stages``), ``sp_attention`` (ring or Ulysses on an sp
mesh) and MoE bundles (``num_experts``, ``capacity_factor``, the router
and expert leaves) cross both ways.

``export_servable``/``load_servable`` take a store (an object with the
reference ``AssetStore``'s ``get(space, kind, id, version)`` returning an
asset with ``.path`` and ``.version``, and ``import_path(space, kind, id,
dir)``); ``export_servable_dir``/``load_servable_dir`` work on the bundle
directory itself.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..data.tokenizer import BpeTokenizer
from ..models.transformer import TransformerConfig, TransformerLM
from .quant import matmul_layout

FORMAT = "k8s-gpu-tpu-servable-v1"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, v


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _to_numpy(t) -> np.ndarray:
    """A leaf as the array the reference's npz holds: bf16 as 2-byte void
    records, the rest as themselves."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _config_fields(doc_cfg: dict, label: str) -> dict:
    fields = dict(doc_cfg)
    known = {f.name for f in dataclasses.fields(TransformerConfig)}
    for name in fields:
        if name not in known:
            raise ValueError(f"{label}: unknown TransformerConfig field "
                             f"{name!r}")
    fields["dtype"] = _DTYPES[fields["dtype"]]
    return fields


def _write_bundle(root, model, params: dict,
                 tokenizer: BpeTokenizer | None = None) -> Path:
    """Write the bundle's files into the directory ``root`` (made if
    missing)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    leaves = {k: _to_numpy(v) for k, v in _flatten(params)}
    cfg = dataclasses.asdict(model.cfg)
    cfg["dtype"] = _dtype_name(model.cfg.dtype)
    doc = {
        "format": FORMAT,
        "model": "TransformerLM",
        "config": cfg,
        "leaves": {
            k: {"dtype": _dtype_name(v.dtype), "shape": list(v.shape)}
            for k, v in _flatten(params)
        },
        "tokenizer": tokenizer is not None,
    }
    (root / "config.json").write_text(json.dumps(doc))
    np.savez(root / "params.npz", **leaves)
    if tokenizer is not None:
        tokenizer.save(root / "tokenizer.json")
    return root


def _read_bundle(root, label: str, device="cuda"):
    """(TransformerLM, params, tokenizer | None) from a bundle directory;
    ValueError when ``root`` is not one (``label`` names it)."""
    root = Path(root)
    not_bundle = ValueError(
        f"{label} is not a servable bundle (raw checkpoint exports lack "
        "config.json — re-export with serve.bundle.export_servable)")
    if not root.is_dir() or not (root / "config.json").exists():
        raise not_bundle
    doc = json.loads((root / "config.json").read_text())
    if doc.get("format") != FORMAT:
        raise not_bundle
    model = TransformerLM(
        TransformerConfig(**_config_fields(doc["config"], label)),
        device=device)
    flat = {}
    with np.load(root / "params.npz") as z:
        for key, meta in doc["leaves"].items():
            a = np.ascontiguousarray(z[key])
            if meta["dtype"] == "bfloat16":
                # 2-byte records (or an ml_dtypes array): the bits of bf16.
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            flat[key] = t.reshape(meta["shape"]).to(model.device)
    tok = None
    if doc.get("tokenizer"):
        tok = BpeTokenizer.load(root / "tokenizer.json")
    return model, matmul_layout(_unflatten(flat)), tok


def export_servable_dir(path, model, params: dict,
                        tokenizer: BpeTokenizer | None = None) -> Path:
    """Write a bundle into the directory ``path``."""
    return _write_bundle(path, model, params, tokenizer)


def load_servable_dir(path, device="cuda"):
    """Bundle directory -> (TransformerLM, params, tokenizer | None), the
    parameters on ``device``."""
    return _read_bundle(path, str(path), device)


def export_servable(store, space: str, asset_id: str, model, params: dict,
                    tokenizer: BpeTokenizer | None = None):
    """Write a bundle into ``store`` as a ``model`` asset; returns the
    store's asset."""
    with tempfile.TemporaryDirectory() as td:
        _write_bundle(td, model, params, tokenizer)
        return store.import_path(space, "model", asset_id, Path(td))


def load_servable(store, space: str, asset_id: str, version: str = "",
                  device="cuda"):
    """A ``model`` asset of ``store`` -> (TransformerLM, params,
    tokenizer | None)."""
    asset = store.get(space, "model", asset_id, version)
    return _read_bundle(asset.path,
                       f"{space}/model/{asset_id}@{asset.version}", device)

