"""Weights carried across from the JAX package.

``params_from_numpy`` turns the reference's params pytree, given as numpy
arrays (``jax.tree.map(np.asarray, params)``), into the port's dict of
tensors on a given device.  bf16 leaves arrive as ``ml_dtypes`` arrays,
which ``torch.from_numpy`` rejects: they are viewed as ``uint16`` and
reinterpreted as ``torch.bfloat16``, bit for bit.  int8 ``{"q", "s"}``
leaves pass through as pairs, each half converted on its own.
``params_to_numpy`` goes the other way, so tests can hold parameters,
gradients and optimizer state against the reference's.
``embedder_from_numpy`` builds the port's ``finagent.TextEmbedder`` on
the reference's projection (``np.asarray(embedder._proj)``): a corpus
embedded by one package is searchable by the other only through it.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype=None):
    """Nested dict of arrays -> the same nesting of tensors on ``device``.
    ``dtype`` (optional) casts float leaves; the int8 half of a quantized
    leaf stays int8 and its scale keeps its own float type unless cast."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return {"q": tensor_from_numpy(tree["q"], device),
                    "s": tensor_from_numpy(tree["s"], device, dtype)}
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return tensor_from_numpy(tree, device, dtype)


def params_to_numpy(tree):
    """Nested dict of tensors (parameters, gradients, optimizer moments)
    -> the same nesting of numpy arrays on the host, detached.  bf16
    leaves widen to float32, exactly (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def embedder_from_numpy(proj, device="cuda"):
    """The port's ``TextEmbedder`` over the reference's ``[n_features,
    dim]`` projection, on ``device``."""
    # Lazy: the finagent package imports the serving and training planes,
    # which import this module.
    from .finagent.embed import TextEmbedder

    n_features, dim = np.shape(proj)
    return TextEmbedder(dim=dim, n_features=n_features, device=device,
                        proj=tensor_from_numpy(proj, "cpu", torch.float32))
