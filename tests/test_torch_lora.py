"""The port's LoRA plane against the JAX package, on the CPU at float32:
the adapter bank, multi-LoRA serving on both pools and the LoRA
fine-tune.

Adapters are made on the JAX side (``LoraAdapter.init``, B set nonzero
from a seed) and carried across through numpy.  Tolerances:
- the banked arrays: equal (both fold the scale into B in float32 with
  numpy);
- ``lora_delta``: atol 1e-6 on values of ~0.1 (two products summed in
  other orders);
- greedy streams: byte-identical to the reference batcher's, base rows
  bitwise unchanged by a bank (tokens and log-probs);
- ``LoraModel`` loss and adapter gradients, three ``Trainer`` steps:
  atol 2e-5, as ``test_torch_train.py`` holds the base model.

The reference's ``test_multilora.py`` and ``test_lora.py`` cases have
counterparts here (``logical_axes`` is held against the reference in
``test_torch_parallel.py``).  Reference batchers run once per module.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.parallel.mesh import MeshConfig, mesh_from_devices
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve.lora_bank import AdapterBank as JaxBank
from k8s_gpu_tpu.serve.lora_bank import lora_delta as jax_lora_delta
from k8s_gpu_tpu.train import TrainConfig as JaxTrainConfig
from k8s_gpu_tpu.train import Trainer as JaxTrainer
from k8s_gpu_tpu.train.lora import LoraAdapter as JaxAdapter
from k8s_gpu_tpu.train.lora import LoraConfig as JaxLoraConfig
from k8s_gpu_tpu.train.lora import LoraModel as JaxLoraModel
from k8s_gpu_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from k8s_gpu_tpu_torch.convert import params_from_numpy, params_to_numpy
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.ops import paged_attention as pa
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, InferenceEngine
from k8s_gpu_tpu_torch.serve import LmServer
from k8s_gpu_tpu_torch.serve.lora_bank import (
    SERVABLE_TARGETS, AdapterBank, lora_delta,
)
from k8s_gpu_tpu_torch.train import (
    LoraAdapter, LoraConfig, LoraModel, TrainConfig, Trainer,
)
from k8s_gpu_tpu_torch.train.lora import num_params
from k8s_gpu_tpu_torch.train.runner import tree_leaves
from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64)
PAGE = 8
BLOCKS = 40
TOL = 2e-5

JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")


def _jax_adapter(cfg, seed):
    """The reference's init with B randomized (B = 0 changes nothing)."""
    tree = JaxAdapter(cfg).init(jax.random.PRNGKey(seed), JP)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 100), 16))
    tree["blocks"] = {
        t: {"a": ab["a"],
            "b": jax.random.normal(next(keys), ab["b"].shape) * 0.05}
        for t, ab in tree["blocks"].items()}
    return tree


CFGS = {"tenant-a": dict(rank=4, targets=("wq", "wv")),
        "tenant-b": dict(rank=8, targets=("wq", "wk", "wv", "wo"))}
JAX_ADAPTERS = {name: (_jax_adapter(JaxLoraConfig(**c), i + 1),
                       JaxLoraConfig(**c))
                for i, (name, c) in enumerate(CFGS.items())}
ADAPTERS = {name: (params_from_numpy(jax.tree.map(np.asarray, tree), "cpu"),
                   LoraConfig(**CFGS[name]))
            for name, (tree, _) in JAX_ADAPTERS.items()}

PREFIX = [(i * 7 + 3) % 60 for i in range(17)]        # 2 pages + a tail
_rng = np.random.default_rng(3)
# (prompt, max_new, adapter): base and adapter rows over one prefix, and
# rows of their own.
MIXED = [
    (PREFIX + [5, 9], 10, None),
    (PREFIX + [5, 9], 10, "tenant-a"),
    (PREFIX + [11], 8, "tenant-b"),
    (_rng.integers(0, 64, 6).tolist(), 12, "tenant-b"),
    (_rng.integers(0, 64, 9).tolist(), 9, None),
    (PREFIX + [2, 2, 2], 7, "tenant-a"),
]
PREFIX_KEYS = ("serve_prefix_cache_hits_total",
               "serve_prefix_cache_misses_total")
PATHS = ("cold", "cold_fused", "prefix_exact", "prefix_suffix",
         "paged_cold", "paged_shared", "precomputed")


def _paths(b) -> dict:
    """Admissions by path, from the serve-plane series (both sides)."""
    got = {p: b.metrics.counter("serve_admissions_total", path=p)
           for p in PATHS}
    return {p: int(n) for p, n in got.items() if n}


def _warm(b, paged: bool):
    """Paged: register PREFIX's full pages; dense: precache PREFIX."""
    if paged:
        b.submit(PREFIX + [9], max_new_tokens=2).result()
    else:
        b.precache_prefix(PREFIX)


def _serve(b, paged: bool, requests=MIXED):
    b.start()
    try:
        _warm(b, paged)
        hs = [b.submit(p, max_new_tokens=n, adapter=a)
              for p, n, a in requests]
        streams = [h.result() for h in hs]
        lps = [h.logprobs for h in hs]
    finally:
        b.stop()
    return streams, lps


def _jax_run(paged: bool):
    kw = dict(paged_blocks=BLOCKS, page_size=PAGE) if paged else {}
    b = JaxBatcher(JM, JP, slots=4, adapters=JAX_ADAPTERS,
                   metrics=JaxRegistry(), **kw)
    streams, _ = _serve(b, paged)
    return streams, _paths(b), {
        k: b.metrics.counter(k) for k in PREFIX_KEYS}


@pytest.fixture(scope="module")
def reference():
    return {"dense": _jax_run(False), "paged": _jax_run(True)}


def _port(paged: bool, impl="gather", adapters=ADAPTERS, **kw):
    kw = dict(kw, paged_blocks=BLOCKS, page_size=PAGE,
              attn_impl=impl) if paged else kw
    return ContinuousBatcher(TM, TP, slots=4, adapters=adapters,
                             metrics=MetricsRegistry(), device="cpu", **kw)


# -- the bank -----------------------------------------------------------------

def test_bank_arrays_equal_reference():
    ref = JaxBank(JAX_ADAPTERS)
    got = AdapterBank(ADAPTERS, device="cpu")
    assert got.names == ref.names == ["__base__", "tenant-a", "tenant-b"]
    assert set(got.banked) == set(ref.banked) == {"wq", "wk", "wv", "wo"}
    for t, ab in ref.banked.items():
        for half in ("a", "b"):
            np.testing.assert_array_equal(got.banked[t][half].numpy(),
                                          np.asarray(ab[half]))
        # Index 0 is the base model: exact zeros.
        assert not got.banked[t]["a"][:, 0].any()
        assert not got.banked[t]["b"][:, 0].any()
    assert got.index(None) == 0 and got.index("tenant-b") == 2
    with pytest.raises(KeyError, match="unknown adapter"):
        got.index("nope")


def test_bank_rejects_unsupported_targets():
    cfg = LoraConfig(rank=2, targets=("wq", "wi_gate"))
    tree = LoraAdapter(cfg).init(0, TP)
    with pytest.raises(ValueError, match="supports"):
        AdapterBank({"bad": (tree, cfg)}, device="cpu")
    assert SERVABLE_TARGETS == ("wq", "wk", "wv", "wo")


def test_lora_delta_matches_reference():
    ref_bank, bank = JaxBank(JAX_ADAPTERS), AdapterBank(ADAPTERS,
                                                        device="cpu")
    x = np.random.default_rng(0).standard_normal((3, 5, 32)).astype(
        np.float32)
    idx = np.array([2, 0, 1], np.int32)
    for t in ("wq", "wo"):
        xi = x[..., :bank.banked[t]["a"].shape[2]]    # d_model = H * Dh
        ref = jax_lora_delta(
            jnp.asarray(xi), jax.tree.map(lambda a: a[1], ref_bank.banked[t]),
            jnp.asarray(idx), jnp.float32)
        got = lora_delta(torch.from_numpy(xi),
                         {k: v[1] for k, v in bank.banked[t].items()},
                         torch.from_numpy(idx), torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
        assert not got[1].any()          # the base row's delta is zero


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("paged,impl", [
    (False, "gather"), (True, "gather"), (True, "paged_kernel"),
])
def test_mixed_streams_match_reference(reference, paged, impl):
    """One batch of base and adapter rows over a shared prefix: the
    streams, the admission paths and the prefix hit/miss counts equal
    the reference's (adapter rows neither share blocks nor take a prefix
    entry).  ``paged_kernel`` runs the kernel's plain version here."""
    ref_streams, ref_paths, ref_counts = reference[
        "paged" if paged else "dense"]
    b = _port(paged, impl)
    pa.reset_counts()
    streams, _ = _serve(b, paged)
    assert streams == ref_streams
    assert [len(s) for s in streams] == [n for _, n, _ in MIXED]
    assert _paths(b) == ref_paths == dict(b.admission_paths)
    assert {k: b.metrics.counter(k) for k in PREFIX_KEYS} == ref_counts
    assert pa.fallback_count == 0
    if paged:
        # Adapter rows take the unshared plan (a left-padded prefill
        # spliced into fresh blocks); the base row over the prefix shares.
        n_adapter = sum(a is not None for _, _, a in MIXED)
        assert ref_paths["cold"] == n_adapter
        assert ref_paths["paged_shared"] == 1
        assert sorted(b._pool.allocatable_blocks()) == list(
            range(1, BLOCKS))


@pytest.mark.parametrize("paged", [False, True])
def test_base_rows_bitwise_unchanged(paged):
    """The zero adapter adds exactly 0: base rows of a banked batcher
    equal a bank-less batcher's, tokens and log-probs bit for bit."""
    base = [(p, n, None) for p, n, _ in MIXED]
    got = _serve(_port(paged, logprobs=True), paged, base)
    ref = _serve(_port(paged, adapters=None, logprobs=True), paged, base)
    assert got == ref


def test_adapter_row_matches_merged_oracle():
    """An adapter row decodes as an engine on the merged weights (the
    low-rank path sums in another order than the merged product, so
    greedy streams, not logits, are held)."""
    eng = InferenceEngine(TM, device="cpu")
    b = _port(False).start()
    try:
        for name in ("tenant-a", "tenant-b"):
            tree, cfg = ADAPTERS[name]
            merged = LoraAdapter(cfg).merge(TP, tree)
            ids = [3, 1, 4, 1, 5]
            got = b.submit(ids, max_new_tokens=8, adapter=name).result()
            out = eng.generate(merged, torch.tensor([ids]), max_new_tokens=8)
            assert got == out.tokens[0].tolist()
    finally:
        b.stop()


def test_unknown_adapter_rejected_at_submit():
    b = _port(False)
    with pytest.raises(KeyError, match="unknown adapter"):
        b.submit([1, 2, 3], adapter="nope")


def test_lm_server_adapter_param():
    """HTTP: {"adapter": name} routes to the adapter; an unknown name or a
    non-string is a 400."""
    tok = BpeTokenizer.train("serve many tenants well " * 30,
                             DIMS["vocab_size"])
    srv = LmServer(TM, TP, tok, adapters=ADAPTERS, device="cpu").start()
    try:
        def post(payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        ids = [7, 3, 11, 19, 23]     # the model's vocabulary is 64 ids
        code, base = post({"prompt_ids": ids, "max_new_tokens": 5})
        code2, ad = post({"prompt_ids": ids, "max_new_tokens": 5,
                          "adapter": "tenant-b"})
        assert code == 200 and code2 == 200
        assert base["ids"] != ad["ids"]
        code3, err = post({"prompt_ids": ids, "adapter": "nope"})
        assert code3 == 400 and "unknown adapter" in err["error"]
        code4, err = post({"prompt_ids": ids, "adapter": 3})
        assert code4 == 400 and "string" in err["error"]
    finally:
        srv.stop()


# -- fine-tuning --------------------------------------------------------------

def _tokens(seed, batch, seq=16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (batch, seq + 1)).astype(
        np.int32)


def test_zero_delta_init_preserves_base():
    lm = LoraModel(TM, TP, LoraConfig(rank=4))
    lora = lm.init(1)
    toks = torch.from_numpy(_tokens(2, 2)[:, :-1])
    base, _ = TM.forward(TP, toks)
    merged, _ = TM.forward(lm.merged_params(lora), toks)
    assert torch.equal(base, merged)       # B = 0: the delta is exactly 0
    assert lora["blocks"]["wq"]["a"].std() > 0.01


def test_adapter_is_small():
    lora = LoraModel(TM, TP, LoraConfig(rank=4)).init(1)
    assert num_params(lora) < 0.2 * num_params(TP)
    assert set(lora["blocks"]) == {"wq", "wk", "wv", "wo"}


def test_extended_targets_and_head():
    lm = LoraModel(TM, TP, LoraConfig(rank=2,
                                      targets=("wq", "wi_gate", "head")))
    lora = lm.init(1)
    assert set(lora["blocks"]) == {"wq", "wi_gate"} and "head" in lora
    assert lm.logical_axes() == {
        "blocks": {"wq": {"a": ("stages", "embed", "lora"),
                          "b": ("stages", "lora", "heads")},
                   "wi_gate": {"a": ("stages", "embed", "lora"),
                               "b": ("stages", "lora", "mlp")}},
        "head": {"a": ("embed", "lora"), "b": ("lora", "vocab")}}
    merged = lm.merged_params(lora)
    for name in ("embed", "head"):
        assert merged[name].shape == TP[name].shape
    for name, w in TP["blocks"].items():
        assert merged["blocks"][name].shape == w.shape


def test_bad_targets_raise():
    with pytest.raises(ValueError):
        LoraModel(TM, TP, LoraConfig(targets=("nope",))).init(0)


def test_loss_and_adapter_grads_match_reference():
    """The same carried adapters (B nonzero) on both sides: the loss on
    the merged weights and every adapter gradient; the base leaves take
    no gradient."""
    tree, cfg = JAX_ADAPTERS["tenant-b"]
    toks = _tokens(0, 2)
    jlm = JaxLoraModel(JM, JP, cfg)
    ref_loss, ref_grads = jax.value_and_grad(jlm.loss)(
        tree, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    lm = LoraModel(TM, TP, LoraConfig(**CFGS["tenant-b"]))
    lora = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    leaves = tree_leaves(lora)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.loss(lora, torch.from_numpy(toks[:, :-1]),
                   torch.from_numpy(toks[:, 1:]))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) < TOL
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(ref_leaves) == len(leaves)
    for p, r in zip(leaves, ref_leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), atol=TOL)
    assert all(t.grad is None for t in tree_leaves(TP))


def test_trainer_trajectory_matches_reference():
    """Three ``Trainer`` steps of ``LoraModel`` from the reference's own
    init (A random, B = 0; warmup 1, so step 1 moves nothing): losses
    and adapters agree, the base leaves stay bit-identical."""
    tc = dict(warmup_steps=1, learning_rate=5e-3)
    jtr = JaxTrainer(JaxLoraModel(JM, JP, JaxLoraConfig(rank=4)),
                     mesh=mesh_from_devices(jax.devices()[:1],
                                            MeshConfig(dp=1)),
                     train_config=JaxTrainConfig(**tc))
    jtr.init(jax.random.PRNGKey(1))
    before = {k: v.clone() for k, v in TP["blocks"].items()}
    ttr = Trainer(LoraModel(TM, TP, LoraConfig(rank=4)), TrainConfig(**tc),
                  device="cpu")
    ttr.init(params=jax.tree.map(np.asarray, jtr.params))
    toks = _tokens(4, 4)
    x, y = toks[:, :-1], toks[:, 1:]
    ref = [float(jtr.step(jnp.asarray(x), jnp.asarray(y)))
           for _ in range(3)]
    got = [ttr.step(torch.from_numpy(x), torch.from_numpy(y))
           for _ in range(3)]
    np.testing.assert_allclose(got, ref, atol=TOL)
    assert got[2] < got[0]
    got_p = params_to_numpy(ttr.params)
    ref_p = jax.tree.map(np.asarray, jtr.params)
    for t in ref_p["blocks"]:
        for half in ("a", "b"):
            np.testing.assert_allclose(got_p["blocks"][t][half],
                                       ref_p["blocks"][t][half], atol=TOL)
    assert np.abs(got_p["blocks"]["wq"]["b"]).max() > 0
    for k, v in before.items():
        assert torch.equal(TP["blocks"][k], v)


def test_lora_fine_tune_launch_counts_on_the_plain_version():
    """On the CPU the flash wrapper takes its plain version: a LoRA step
    with remat calls it twice a layer (forward and the recomputed
    forward), the same as the base model's step."""
    from k8s_gpu_tpu_torch.ops import attention as fa

    tm = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32,
                                         use_flash=True, remat=True),
                       device="cpu")
    tr = Trainer(LoraModel(tm, TP, LoraConfig(rank=4)),
                 TrainConfig(warmup_steps=1), device="cpu")
    tr.init(seed=0)
    toks = torch.from_numpy(_tokens(5, 2))
    fa.reset_counts()
    tr.step(toks[:, :-1], toks[:, 1:])
    assert fa.plain_count == 2 * DIMS["n_layers"]


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged kernel and the adapter "
                    "bank's products run on the card")
    return torch.device("cuda")


# The kernel's shapes: heads of 64, pages of 16.
GPU_DIMS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
                d_head=64, n_kv_heads=1, d_ff=128, max_seq=128)


@pytest.mark.gpu
def test_cuda_multi_lora_paged_kernel_exact_launches(cuda):
    """A mixed batch on the paged pool through the kernel (float32): the
    kernel launches once a layer for every kernel admission and decode
    step, nothing falls back, and the streams equal the CPU's plain
    version's."""
    from k8s_gpu_tpu_torch.ops import _build

    _build.load("paged_attention")
    jm = JaxLM(JaxConfig(**GPU_DIMS, use_flash=False, dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(1))
    # The adapters are drawn on the CPU (a generator on the card draws
    # other numbers) and moved to each side's device.
    host = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    trees = {}
    for i, (name, c) in enumerate(CFGS.items()):
        tree = LoraAdapter(LoraConfig(**c)).init(i + 1, host)
        gen = torch.Generator().manual_seed(i + 7)
        for ab in tree["blocks"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.05
        trees[name] = tree
    streams = {}
    for dev in ("cpu", cuda):
        tm = TransformerLM(TransformerConfig(**GPU_DIMS,
                                             dtype=torch.float32),
                           device=dev)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), dev)
        adapters = {
            name: ({"blocks": {t: {h: x.to(dev) for h, x in ab.items()}
                               for t, ab in trees[name]["blocks"].items()}},
                   LoraConfig(**c))
            for name, c in CFGS.items()}
        b = ContinuousBatcher(tm, tp, slots=4, adapters=adapters,
                              paged_blocks=BLOCKS, page_size=16,
                              attn_impl="paged_kernel", device=dev).start()
        try:
            b.submit(PREFIX + [9], max_new_tokens=2).result()
            if dev != "cpu":
                torch.cuda.synchronize()
            w0 = (b.admission_paths["paged_cold"]
                  + b.admission_paths["paged_shared"]
                  + b.dispatched["decode_steps"])
            pa.reset_counts()
            hs = [b.submit(p, max_new_tokens=n, adapter=a)
                  for p, n, a in MIXED]
            streams[str(dev)] = [h.result() for h in hs]
            if dev != "cpu":
                torch.cuda.synchronize()
            work = (b.admission_paths["paged_cold"]
                    + b.admission_paths["paged_shared"]
                    + b.dispatched["decode_steps"]) - w0
            launches, fallbacks = pa.launch_count, pa.fallback_count
        finally:
            b.stop()
    assert fallbacks == 0
    assert launches == GPU_DIMS["n_layers"] * work
    assert streams["cpu"] == streams[str(cuda)]
