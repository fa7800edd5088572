"""The port's ``SmallCnn`` against the JAX package's at float32: the same
weights (the reference's HWIO/NHWC layout, carried leaf for leaf by
``convert.py``) and the same images give the logits, the loss and the
gradients within 1e-5 (relative and absolute: the two frameworks sum the
convolutions in other orders), and the port's ``Trainer`` trains it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import CnnConfig as JaxCnnConfig
from k8s_gpu_tpu.models import SmallCnn as JaxCnn
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import CnnConfig, SmallCnn
from k8s_gpu_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(seed, batch):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("seed,batch", [(0, 2), (1, 5)])
def test_forward_loss_and_grads_match_reference(seed, batch):
    jm = JaxCnn(JaxCnnConfig(dtype=jnp.float32))
    tm = SmallCnn(CnnConfig(dtype=torch.float32), device="cpu")
    jp = jm.init(jax.random.PRNGKey(seed))
    images, labels = _inputs(seed, batch)
    ref_logits = np.asarray(jm.forward(jp, jnp.asarray(images)))
    ref_loss, ref_grads = jax.value_and_grad(jm.loss)(
        jp, jnp.asarray(images), jnp.asarray(labels))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for p in params.values():
        p.requires_grad_(True)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    logits = tm.forward(params, x)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits,
                               rtol=TOL, atol=TOL)
    loss = tm.loss(params, x, y)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) < TOL
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grads[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_init_layout_matches_reference():
    ref = JaxCnn().init(jax.random.PRNGKey(0))
    got = SmallCnn(device="cpu").init(0)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    # He-normal scales: std sqrt(2 / fan_in).
    assert float(got["fc1"].std()) == pytest.approx((2 / 3136) ** 0.5,
                                                    rel=0.05)


def test_trainer_trains_the_cnn_in_bf16():
    model = SmallCnn(device="cpu")
    tr = Trainer(model, TrainConfig(warmup_steps=1, learning_rate=1e-3),
                 device="cpu")
    tr.init(0)
    images, labels = _inputs(3, 8)
    images = images * 0.1 + labels[:, None, None, None] / 10.0
    losses = [tr.step(images, labels) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert model.forward(tr.params, torch.from_numpy(images)).dtype == \
        torch.float32
