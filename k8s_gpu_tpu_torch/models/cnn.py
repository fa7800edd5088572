"""The two-convolution CNN of the platform's image workload: the port of
``k8s_gpu_tpu/models/cnn.py``.

Parameters keep the reference's layout, HWIO convolution kernels and
``[in, out]`` dense weights, and images come NHWC, so weights cross from
the JAX package leaf for leaf.  The forward turns them to torch's NCHW
and OIHW at the call and flattens the pooled features in NHWC order, as
the reference does.  The convolutions run in plain torch (cuDNN on the
card): the reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.mesh import axis_size


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

    def forward(self, params, images):
        """images [B, H, W, 1] -> logits [B, classes] f32."""
        dt = self.cfg.dtype
        x = images.to(dt).permute(0, 3, 1, 2)                  # NCHW

        def conv(x, w):                                        # w: HWIO
            return F.conv2d(x, w.to(dt).permute(3, 2, 0, 1), padding=1)

        x = F.max_pool2d(F.relu(conv(x, params["conv1"])), 2)
        x = F.max_pool2d(F.relu(conv(x, params["conv2"])), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # NHWC order
        x = F.relu(x @ params["fc1"].to(dt))
        return (x @ params["fc2"].to(dt)).float()

    def loss(self, params, images, labels, mesh=None):
        """Mean cross-entropy of this rank's images.  On a mesh the
        ``Trainer`` averages it over the ranks, which is the global mean
        for a dp split; an sp axis would cut every image along H, so it
        is refused."""
        if axis_size(mesh, "sp") > 1:
            raise NotImplementedError(
                "the CNN on an sp mesh: sp cuts token sequences, and an "
                "image cut along H is not the image; use dp")
        logp = torch.log_softmax(self.forward(params, images), dim=-1)
        return -logp.gather(-1, labels.long()[:, None]).mean()
