"""Servable bundles across the two packages, on the CPU.

A bundle the reference exports (float32, bf16, int8, with a tokenizer)
loads in the port with bit-equal leaves and serves the reference's greedy
stream (float32 and int8 over a float32 model: byte-identical; bf16: the
same stream on this model, the two frameworks round the same bf16
products); a bundle the port exports loads in the reference's
``load_servable`` with bit-equal leaves.  Reference-only config fields
load at their defaults and are refused otherwise.  The reference's
``test_bundle.py`` cases have counterparts here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.data.tokenizer import BpeTokenizer as JaxTokenizer
from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.platform.assets import AssetStore
from k8s_gpu_tpu.serve import InferenceEngine as JaxEngine
from k8s_gpu_tpu.serve import export_servable as jax_export
from k8s_gpu_tpu.serve import load_servable as jax_load
from k8s_gpu_tpu.serve import quantize_params as jax_quantize
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import (
    InferenceEngine, export_servable, export_servable_dir, load_servable,
    load_servable_dir, quantize_params,
)
from k8s_gpu_tpu_torch.serve.bundle import _flatten, _unflatten

torch.set_num_threads(1)

DIMS = dict(vocab_size=300, d_model=32, n_layers=2, n_heads=2, d_head=16,
            d_ff=64, max_seq=64)


def _jax_model(dtype=jnp.float32, **extra):
    m = JaxLM(JaxConfig(**DIMS, dtype=dtype, use_flash=False, remat=False,
                        **extra))
    return m, m.init(jax.random.PRNGKey(0))


def _bits(x) -> np.ndarray:
    """A leaf's bytes as integers (bf16 as its 16 bits)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.dtype(f"i{x.element_size()}"))
    a = np.asarray(x)
    return np.ascontiguousarray(a).view(np.dtype(f"i{a.dtype.itemsize}"))


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _assert_same_leaves(a: dict, b: dict):
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert _dtype_name(fa[k]) == _dtype_name(fb[k]), k
        assert tuple(fa[k].shape) == tuple(fb[k].shape), k
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]), err_msg=k)


def _jax_stream(model, params, prompt, n=6):
    out = JaxEngine(model).generate(params, jnp.asarray([prompt]),
                                    max_new_tokens=n)
    return np.asarray(out.tokens)[0].tolist()


def _stream(model, params, prompt, n=6, **kw):
    eng = InferenceEngine(model, device="cpu", **kw)
    return eng.generate(params, torch.tensor([prompt]),
                        max_new_tokens=n).tokens[0].tolist()


PROMPT = [1, 5, 9, 2, 7]


def test_flatten_roundtrip():
    tree = {"a": 1, "b": {"c": 2, "d": {"e": 3}}}
    assert _unflatten(dict(_flatten(tree))) == tree


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_reference_bundle_loads_and_serves(tmp_path, kind):
    store = AssetStore(tmp_path)
    jm, jp = _jax_model(jnp.bfloat16 if kind == "bfloat16" else jnp.float32)
    if kind == "int8":
        jp = jax_quantize(jp)
    jax_export(store, "ml", "lm", jm, jp)
    model, params, tok = load_servable(store, "ml", "lm", device="cpu")
    assert tok is None
    assert model.cfg == TransformerConfig(
        **DIMS, dtype=torch.bfloat16 if kind == "bfloat16"
        else torch.float32, use_flash=False, remat=False)
    _assert_same_leaves(params, jax.tree.map(np.asarray, jp))
    if kind == "int8":
        assert params["blocks"]["wq"]["q"].dtype == torch.int8
        assert params["blocks"]["wq"]["s"].dtype == torch.float32
    assert _stream(model, params, PROMPT) == _jax_stream(jm, jp, PROMPT)


def test_int8_bundle_serves_with_int8_compute(tmp_path):
    """A port-quantized tree through a bundle: the loaded tree serves
    with ``int8_compute`` as the in-memory one does (its matmul leaves
    laid out as ``quantize_params`` lays them)."""
    tm = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                       device="cpu")
    qp = quantize_params(tm.init(0))
    export_servable_dir(tmp_path / "b", tm, qp)
    m2, p2, _ = load_servable_dir(tmp_path / "b", device="cpu")
    _assert_same_leaves(p2, qp)
    for name in ("wq", "wo", "wi_gate"):
        assert p2["blocks"][name]["q"].stride() == \
            qp["blocks"][name]["q"].stride()
    assert _stream(m2, p2, PROMPT, int8_compute=True) == _stream(
        tm, qp, PROMPT, int8_compute=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_bundle_loads_in_the_reference(tmp_path, dtype):
    """The port writes the reference's format: ``load_servable`` of the
    reference reads it with bit-equal leaves (bf16 as 2-byte records),
    int8 ``{q, s}`` leaves included, and the same config."""
    store = AssetStore(tmp_path)
    tm = TransformerLM(TransformerConfig(**DIMS, dtype=dtype), device="cpu")
    params = tm.init(0)
    params["head"] = quantize_params(params)["head"]
    tok = JaxTokenizer.train("the quick brown fox " * 40, vocab_size=280,
                             backend="python")
    from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer

    export_servable(store, "ml", "lm", tm, params,
                    tokenizer=BpeTokenizer(tok.merges))
    jm, jp, jtok = jax_load(store, "ml", "lm")
    _assert_same_leaves(params, jax.tree.map(np.asarray, jp))
    assert jm.cfg.dtype == (jnp.bfloat16 if dtype == torch.bfloat16
                            else jnp.float32)
    assert jm.cfg.d_model == DIMS["d_model"]
    assert jtok.encode("the quick brown fox").tolist() == tok.encode(
        "the quick brown fox").tolist()


def test_bundle_with_tokenizer_and_versioning(tmp_path):
    store = AssetStore(tmp_path)
    jm, jp = _jax_model()
    tok = JaxTokenizer.train("the quick brown fox " * 40, vocab_size=280,
                             backend="python")
    jax_export(store, "ml", "lm", jm, jp, tokenizer=tok)
    jax_export(store, "ml", "lm", jm, jp, tokenizer=tok)
    assert store.versions("ml", "model", "lm") == ["v1", "v2"]
    _, _, tok2 = load_servable(store, "ml", "lm", version="v1", device="cpu")
    ids = tok2.encode("the quick brown fox")
    assert ids.tolist() == tok.encode("the quick brown fox").tolist()
    assert tok2.decode(ids) == "the quick brown fox"


@pytest.mark.parametrize("field,value", [
    ("pp_schedule", "gpipe"),
    ("pp_microbatches", 4),
    ("pp_virtual_stages", 2),
])
def test_non_default_reference_only_field_refused(tmp_path, field, value):
    """The pipeline fields were the reference's alone; the port's config
    has them now, so a bundle the reference wrote with a non-default
    value loads with it (the name is the older test's)."""
    store = AssetStore(tmp_path)
    jm, jp = _jax_model(**{field: value})
    jax_export(store, "ml", "lm", jm, jp)
    model, params, _ = load_servable(store, "ml", "lm", device="cpu")
    assert getattr(model.cfg, field) == value
    assert params["embed"].shape == tuple(np.asarray(jp["embed"]).shape)


def test_unknown_config_field_refused(tmp_path):
    import json

    tm = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                       device="cpu")
    root = export_servable_dir(tmp_path / "b", tm, tm.init(0))
    doc = json.loads((root / "config.json").read_text())
    doc["config"]["moe_router"] = "switch"
    (root / "config.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="unknown TransformerConfig field"):
        load_servable_dir(root, device="cpu")


def test_non_bundle_asset_rejected(tmp_path):
    store = AssetStore(tmp_path)
    store.import_bytes("ml", "model", "raw", b"not a bundle")
    with pytest.raises(ValueError, match="not a servable bundle"):
        load_servable(store, "ml", "raw", device="cpu")
    with pytest.raises(ValueError, match="not a servable bundle"):
        load_servable_dir(tmp_path / "nowhere", device="cpu")


def test_dir_round_trip_is_bit_equal(tmp_path):
    jm, jp = _jax_model(jnp.bfloat16)
    tm = TransformerLM(TransformerConfig(**DIMS, dtype=torch.bfloat16),
                       device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    export_servable_dir(tmp_path / "b", tm, params)
    m2, p2, _ = load_servable_dir(tmp_path / "b", device="cpu")
    assert m2.cfg == tm.cfg
    _assert_same_leaves(p2, params)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bundle loads onto the card "
                    "and serves there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_bundle_round_trip(tmp_path, cuda):
    """bf16 and int8 bundles written from the card load back onto it bit
    for bit and serve the in-memory stream (int8 with int8_compute)."""
    tm = TransformerLM(TransformerConfig(**DIMS, dtype=torch.bfloat16),
                       device=cuda)
    params = tm.init(0)
    for name, tree, kw in (("bf16", params, {}),
                           ("int8", quantize_params(params),
                            {"int8_compute": True})):
        export_servable_dir(tmp_path / name, tm, tree)
        m2, p2, _ = load_servable_dir(tmp_path / name, device=cuda)
        assert next(iter(dict(_flatten(p2)).values())).device.type == "cuda"
        _assert_same_leaves(p2, tree)
        prompt = torch.tensor([PROMPT], device=cuda)
        ref = InferenceEngine(tm, device=cuda, **kw).generate(
            tree, prompt, max_new_tokens=6).tokens
        got = InferenceEngine(m2, device=cuda, **kw).generate(
            p2, prompt, max_new_tokens=6).tokens
        assert torch.equal(got, ref)
