"""The two-convolution CNN of the platform's image workload: the port of
``k8s_gpu_tpu/models/cnn.py``.

Parameters keep the reference's layout, HWIO convolution kernels and
``[in, out]`` dense weights, and images come NHWC, so weights cross from
the JAX package leaf for leaf.  The forward turns them to torch's NCHW
and OIHW at the call and flattens the pooled features in NHWC order, as
the reference does.  The convolutions run in plain torch (cuDNN on the
card): the reference computes them outside any Pallas kernel.

On a mesh the model trains wherever the reference's ``Trainer`` trains
it.  Its logical axes are the reference's: ``fc1`` is cut over tp on
its output (column-parallel, the features entering through
``copy_to``) and ``fc2`` on its input (row-parallel, the logits summed
over tp by ``reduce_from``); nothing is cut over ep or pp, whose ranks
compute the same step.  On sp the ``Trainer`` lays each image out over
sp along H, as the reference's ``P("dp", "sp")`` does, and the loss
gathers it back: every rank of an sp group computes the whole images
of its dp block, as GSPMD does for the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.collectives import all_gather, copy_to, reduce_from
from ..parallel.mesh import axis_group


@dataclass(frozen=True)
class CnnConfig:
    num_classes: int = 10
    c1: int = 32
    c2: int = 64
    d_hidden: int = 128
    in_hw: int = 28
    dtype: torch.dtype = torch.bfloat16


class SmallCnn:
    def __init__(self, cfg: CnnConfig = CnnConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0, dtype=torch.float32) -> dict:
        """He-normal weights with the reference's shapes, drawn from a
        generator seeded with ``seed`` on the model's device."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        # After two stride-2 max pools: 28 -> 14 -> 7.
        flat = (cfg.in_hw // 4) ** 2 * cfg.c2

        def he(shape, fan):
            x = torch.randn(shape, generator=gen, device=self.device)
            return (x * (2.0 / fan) ** 0.5).to(dtype)

        return {
            "conv1": he((3, 3, 1, cfg.c1), 9),
            "conv2": he((3, 3, cfg.c1, cfg.c2), 9 * cfg.c1),
            "fc1": he((flat, cfg.d_hidden), flat),
            "fc2": he((cfg.d_hidden, cfg.num_classes), cfg.d_hidden),
        }

    def logical_axes(self) -> dict:
        """The reference's table: the hidden layer's width over "mlp"."""
        return {
            "conv1": (None, None, None, None),
            "conv2": (None, None, None, None),
            "fc1": (None, "mlp"),
            "fc2": ("mlp", None),
        }

    def forward(self, params, images, mesh=None):
        """images [B, H, W, 1] -> logits [B, classes] f32.  On a tp mesh
        ``params`` are this rank's shards (``fc1``'s columns, ``fc2``'s
        rows) and the logits are summed over tp."""
        dt = self.cfg.dtype
        x = images.to(dt).permute(0, 3, 1, 2)                  # NCHW

        def conv(x, w):                                        # w: HWIO
            return F.conv2d(x, w.to(dt).permute(3, 2, 0, 1), padding=1)

        x = F.max_pool2d(F.relu(conv(x, params["conv1"])), 2)
        x = F.max_pool2d(F.relu(conv(x, params["conv2"])), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # NHWC order
        tp = axis_group(mesh, "tp")
        x = F.relu(copy_to(x, tp) @ params["fc1"].to(dt))
        return reduce_from(x @ params["fc2"].to(dt), tp).float()

    def loss(self, params, images, labels, mesh=None):
        """Mean cross-entropy of this rank's images.  On a mesh the
        ``Trainer`` averages it over the batch group, which is the
        global mean; on sp the rank's H block of each image is gathered
        into the whole image first (module docstring)."""
        sp = axis_group(mesh, "sp")
        if sp is not None:
            images = torch.cat(all_gather(images, sp), 1)
        logp = torch.log_softmax(self.forward(params, images, mesh), dim=-1)
        return -logp.gather(-1, labels.long()[:, None]).mean()
