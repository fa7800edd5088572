"""The port's ``CheckpointManager`` and ``attach_to_trainer``: round trip,
retention, atomic saves, telemetry, the reference's ``AssetStore``, the
EMA and its re-seed, and a saved-and-resumed trajectory: bit for bit
the uninterrupted port run, and within ``TOL`` (``test_torch_train.py``'s:
2e-5 on losses and parameters) the reference ``Trainer``'s own Orbax
save/resume trajectory from the same weights and tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig, build_mesh
from k8s_gpu_tpu.platform.assets import AssetStore
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu_torch.convert import params_to_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.train import TrainConfig, Trainer
from k8s_gpu_tpu_torch.train import checkpoint as ck
from k8s_gpu_tpu_torch.train.checkpoint import (
    CheckpointManager, attach_to_trainer,
)
from k8s_gpu_tpu_torch.train.runner import tree_leaves
from k8s_gpu_tpu_torch.utils.clock import TickingFakeClock
from k8s_gpu_tpu_torch.utils.goodput import GoodputLedger, goodput_snapshot
from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            d_ff=64, max_seq=16)
TOL = 2e-5
TC = dict(warmup_steps=2, learning_rate=1e-3)


def _tokens(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, DIMS["vocab_size"], (2, DIMS["max_seq"] + 1))
            .astype(np.int32) for _ in range(n)]


def _trainer(seed=0, ledger=None, **tc):
    model = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                          device="cpu")
    tr = Trainer(model, TrainConfig(**{**TC, **tc}), device="cpu",
                 ledger=ledger)
    tr.init(seed)
    return tr


def _steps(tr, toks):
    return [tr.step(t[:, :-1], t[:, 1:]) for t in toks]


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"embed": torch.randn(4, 3, generator=g),
            "blocks": {"wq": torch.randn(2, 3, 5, generator=g),
                       "ln1": torch.randn(2, 3, generator=g)}}


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.mark.parametrize("with_ema", [False, True])
def test_round_trip(tmp_path, with_ema):
    mgr = CheckpointManager(tmp_path)
    params = _tree(0)
    opt = {"count": 7, "mu": _tree(1), "nu": _tree(2)}
    ema = _tree(3) if with_ema else None
    mgr.save(5, params, opt, ema=ema)
    assert mgr.latest_step() == 5 and mgr._has_ema(5) == with_ema
    like = {k: (torch.zeros_like(v) if torch.is_tensor(v) else
                {n: torch.zeros_like(t).requires_grad_(True)
                 for n, t in v.items()}) for k, v in _tree(9).items()}
    opt_like = {"count": 0, "mu": _tree(9), "nu": _tree(9)}
    out = mgr.restore(like, opt_like, ema_like=_tree(9) if with_ema else None)
    if with_ema:
        got, got_opt, got_ema, step = out
        assert _equal(got_ema, ema)
    else:
        got, got_opt, step = out
    assert step == 5 and got_opt["count"] == 7
    assert _equal(got, params)
    assert _equal(got_opt["mu"], opt["mu"]) and _equal(got_opt["nu"],
                                                        opt["nu"])
    # Each leaf takes its like leaf's requires_grad.
    assert got["blocks"]["wq"].requires_grad and not got["embed"].requires_grad
    # The moments are stored by parameter path, not by list order.
    raw = torch.load(tmp_path / "5" / "opt_state.pt", weights_only=True)
    assert set(raw["mu"]) == {"embed", "blocks/wq", "blocks/ln1"}


def test_retention_and_missing_steps(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree(0), {"mu": _tree(0), "nu": _tree(0)})
    opt = {"count": 1, "mu": _tree(1), "nu": _tree(2)}
    for step in (2, 4, 6, 8):
        mgr.save(step, _tree(step), opt)
    assert mgr.all_steps() == [6, 8] and mgr.latest_step() == 8
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree(0), opt, step=4)
    _, _, step = mgr.restore(_tree(0), opt, step=6)
    assert step == 6
    with pytest.raises(KeyError, match="extra"):
        mgr.restore({**_tree(0), "extra": torch.zeros(1)}, opt)


def test_crash_mid_save_never_becomes_latest(tmp_path, monkeypatch):
    reg = MetricsRegistry()
    mgr = CheckpointManager(tmp_path, registry=reg)
    opt = {"count": 1, "mu": _tree(1), "nu": _tree(2)}
    mgr.save(1, _tree(0), opt)
    real = ck._write

    def dies_on_moments(obj, path):
        if path.name == "opt_state.pt":
            raise OSError("disk full")
        real(obj, path)

    monkeypatch.setattr(ck, "_write", dies_on_moments)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, _tree(0), opt)
    assert mgr.latest_step() == 1
    assert reg.counter("train_checkpoint_failures_total", op="save") == 1.0
    assert reg.histogram("train_checkpoint_seconds", op="save").n == 1


def test_telemetry_segments_and_failures(tmp_path, monkeypatch):
    """As the reference's ``test_checkpoint_save_restore_telemetry``:
    seconds by op, the bytes gauge, the ledger's two segments, the
    failure counter and the ``/debug/goodput`` checkpoint half."""
    clk = TickingFakeClock()
    reg = MetricsRegistry()
    led = GoodputLedger(registry=reg, clock=clk)
    tr = _trainer(ledger=led)
    ckpt, save, resume = attach_to_trainer(tr, tmp_path / "ck", clock=clk,
                                           registry=reg)
    save(1)
    assert reg.histogram("train_checkpoint_seconds", op="save").n == 1
    assert reg.gauge("train_checkpoint_bytes") == ckpt._step_bytes(1) > 0
    assert resume() == 1
    assert reg.histogram("train_checkpoint_seconds", op="restore").n == 1
    segs = led.snapshot()["segments"]
    assert segs["checkpoint_save"]["count"] == 1
    assert segs["checkpoint_save"]["seconds"] > 0.0
    assert segs["checkpoint_restore"]["count"] == 1

    def disk_full(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(ckpt, "_save", disk_full)
    with pytest.raises(RuntimeError, match="disk full"):
        save(2)
    assert reg.counter("train_checkpoint_failures_total", op="save") == 1.0
    monkeypatch.setattr(ck, "_Reader", disk_full)
    with pytest.raises(RuntimeError, match="disk full"):
        resume()
    assert reg.counter("train_checkpoint_failures_total",
                       op="restore") == 1.0
    snap = goodput_snapshot(led, reg)
    assert snap["checkpoint"]["ops"]["save"]["p95_s"] > 0.0
    assert snap["checkpoint"]["ops"]["save"]["failures"] == 1.0
    assert snap["checkpoint"]["ops"]["restore"]["failures"] == 1.0
    assert snap["checkpoint"]["last_bytes"] > 0.0
    ckpt.close()


def test_export_to_assets_into_reference_store(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        mgr.export_to_assets(AssetStore(tmp_path / "assets"), "team", "lm")
    opt = {"count": 3, "mu": _tree(1), "nu": _tree(2)}
    mgr.save(3, _tree(0), opt)
    mgr.save(4, _tree(5), opt)
    store = AssetStore(tmp_path / "assets")
    asset = mgr.export_to_assets(store, "team", "lm", step=3)
    assert (asset.kind, asset.id, asset.version) == ("model", "lm", "v1")
    assert asset.size == mgr._step_bytes(3)
    from pathlib import Path
    assert sorted(p.name for p in Path(asset.path).iterdir()) == [
        "opt_state.pt", "params.pt"]
    latest = mgr.export_to_assets(store, "team", "lm")
    assert latest.version == "v2" and latest.size == mgr._step_bytes(4)


def test_resumed_trajectory_is_bit_identical(tmp_path):
    """3 steps, save, a fresh ``Trainer`` (other init seed) resumes and
    takes 2 more: losses, parameters and AdamW state equal an
    uninterrupted 5-step run bit for bit (the warmup of 2 steps shows a
    lost ``count``)."""
    toks = _tokens(5)
    straight = _trainer()
    ref_losses = _steps(straight, toks)
    first = _trainer()
    losses = _steps(first, toks[:3])
    _, save, _ = attach_to_trainer(first, tmp_path)
    save(3)
    resumed = _trainer(seed=11)
    _, _, resume = attach_to_trainer(resumed, tmp_path)
    assert resume() == 3
    assert resumed.opt_state["count"] == 3
    losses += _steps(resumed, toks[3:])
    assert losses == ref_losses
    assert _equal(resumed.params, straight.params)
    for key in ("mu", "nu"):
        assert _equal(resumed.opt_state[key], straight.opt_state[key])
    assert all(p.requires_grad for p in tree_leaves(resumed.params))


def test_resumed_trajectory_matches_reference(tmp_path):
    """The same save/resume walk through the reference ``Trainer`` and
    its Orbax manager, from the same weights and tokens.  (Imported
    here: a machine without Orbax still runs this file's other tests.)"""
    from k8s_gpu_tpu.train.checkpoint import (
        attach_to_trainer as jax_attach_to_trainer,
    )

    toks = _tokens(5, seed=1)
    mesh = build_mesh(MeshConfig(dp=1), n_devices=1)
    jm = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))

    def jax_trainer():
        tr = JaxTrainer(jm, mesh=mesh, train_config=JaxTrainConfig(**TC))
        tr.init(jax.random.PRNGKey(0))
        return tr

    ref = jax_trainer()
    init = jax.tree.map(np.asarray, ref.params)
    ref_losses = [ref.step(t[:, :-1], t[:, 1:]) for t in toks[:3]]
    ckpt, save, _ = jax_attach_to_trainer(ref, tmp_path / "ref")
    save(3)
    ckpt.close()
    ref = jax_trainer()
    ckpt, _, resume = jax_attach_to_trainer(ref, tmp_path / "ref")
    assert resume() == 3
    ckpt.close()
    ref_losses += [ref.step(t[:, :-1], t[:, 1:]) for t in toks[3:]]

    model = TransformerLM(TransformerConfig(**DIMS, use_flash=False,
                                            dtype=torch.float32),
                          device="cpu")
    first = Trainer(model, TrainConfig(**TC), device="cpu")
    first.init(params=init)
    losses = _steps(first, toks[:3])
    attach_to_trainer(first, tmp_path / "port")[1](3)
    resumed = Trainer(model, TrainConfig(**TC), device="cpu")
    resumed.init(seed=3)
    assert attach_to_trainer(resumed, tmp_path / "port")[2]() == 3
    losses += _steps(resumed, toks[3:])
    np.testing.assert_allclose(losses, ref_losses, atol=TOL)
    got = params_to_numpy(resumed.params)
    want = jax.tree.map(np.asarray, ref.params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=TOL)


def test_ema_restore_and_pre_ema_reseed(tmp_path):
    """An EMA checkpoint restores the shadow (detached); a checkpoint without one
    seeds the shadow from the restored params, not the fresh init's."""
    toks = _tokens(3, seed=2)
    tr = _trainer(ema_decay=0.5)
    _steps(tr, toks)
    attach_to_trainer(tr, tmp_path / "ema")[1](3)
    back = _trainer(seed=4, ema_decay=0.5)
    attach_to_trainer(back, tmp_path / "ema")[2]()
    assert _equal(back.ema, tr.ema) and not _equal(back.ema, back.params)
    assert not any(e.requires_grad for e in tree_leaves(back.ema))

    plain = _trainer()
    _steps(plain, toks)
    attach_to_trainer(plain, tmp_path / "plain")[1](3)
    back = _trainer(seed=4, ema_decay=0.5)
    fresh = [e.clone() for e in tree_leaves(back.ema)]
    attach_to_trainer(back, tmp_path / "plain")[2]()
    assert _equal(back.ema, plain.params) and _equal(back.params,
                                                     plain.params)
    assert not all(torch.equal(a, b) for a, b in
                   zip(fresh, tree_leaves(back.ema)))
    assert not any(e.requires_grad for e in tree_leaves(back.ema))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU "
                    "mode (chip_smoke.py holds the resume on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_resume_is_bit_identical_under_deterministic_mode(cuda,
                                                               tmp_path,
                                                               monkeypatch):
    """bf16 through the flash kernels on the card: 2 steps, save, resume
    in a fresh ``Trainer``, step 3 equals the uninterrupted step 3 bit
    for bit under ``torch.use_deterministic_algorithms``."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                            n_heads=2, d_head=64, d_ff=256, max_seq=128)
    gen = torch.Generator().manual_seed(0)
    toks = [torch.randint(0, 256, (2, 129), generator=gen).to(cuda)
            for _ in range(3)]
    torch.use_deterministic_algorithms(True)
    try:
        def trainer(seed):
            tr = Trainer(TransformerLM(cfg, device=cuda),
                         TrainConfig(warmup_steps=1), device=cuda)
            tr.init(seed)
            return tr

        straight = trainer(0)
        want = _steps(straight, toks)
        first = trainer(0)
        _steps(first, toks[:2])
        attach_to_trainer(first, tmp_path)[1](2)
        resumed = trainer(5)
        assert attach_to_trainer(resumed, tmp_path)[2]() == 2
        assert _steps(resumed, toks[2:]) == want[2:]
        assert _equal(resumed.params, straight.params)
    finally:
        torch.use_deterministic_algorithms(False)
