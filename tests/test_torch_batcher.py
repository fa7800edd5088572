"""The port's ContinuousBatcher on the paged pool against the JAX
reference batcher, same weights, float32.

Greedy streams must be byte-identical, for concurrent requests of mixed
lengths including two that share a page-aligned prefix (the second maps
the first's blocks: ``prefix_tokens > 0``); greedy logprobs agree to
atol 1e-4.  Sampled streams cannot match the reference's ``jax.random``
draws, so they are held to valid ids, the same ids for the same seed, and
the reference's sampling distribution.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_tpu.models import TransformerConfig as JaxConfig
from k8s_gpu_tpu.models import TransformerLM as JaxLM
from k8s_gpu_tpu.serve import ContinuousBatcher as JaxBatcher
from k8s_gpu_tpu.serve.engine import InferenceEngine as JaxEngine
from k8s_gpu_tpu.serve.engine import SamplingConfig as JaxSampling
from k8s_gpu_tpu_torch.convert import params_from_numpy
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ConstraintBank, ContinuousBatcher
from k8s_gpu_tpu_torch.serve import Overloaded
from k8s_gpu_tpu_torch.serve.engine import gumbel_sample, nucleus_mask

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
            n_kv_heads=2, d_ff=64, max_seq=64)
PAGE = 8
BLOCKS = 32
JM = JaxLM(JaxConfig(**DIMS, use_flash=False, dtype=jnp.float32))
JP = JM.init(jax.random.PRNGKey(0))
TM = TransformerLM(TransformerConfig(**DIMS, dtype=torch.float32),
                   device="cpu")
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")

_rng = np.random.default_rng(1)
_PREFIX = _rng.integers(0, 64, 2 * PAGE).tolist()
# (prompt, max_new): the shared-prefix pair first, so the second request
# is planned after the first registered the prefix blocks.
REQUESTS = [
    (_PREFIX + [3, 4, 5], 9),
    (_PREFIX + [9], 6),
    (_rng.integers(0, 64, 5).tolist(), 7),
    (_rng.integers(0, 64, 12).tolist(), 12),
    (_rng.integers(0, 64, 30).tolist(), 20),
    (_rng.integers(0, 64, 3).tolist(), 4),
]


def _port(**kw):
    return ContinuousBatcher(TM, TP, slots=3, paged_blocks=BLOCKS,
                             page_size=PAGE, device="cpu", **kw)


def _run(batcher):
    handles = [batcher.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    return ([h.result() for h in handles], [h.logprobs for h in handles])


@pytest.fixture(scope="module")
def reference():
    b = JaxBatcher(JM, JP, slots=3, paged_blocks=BLOCKS, page_size=PAGE,
                   logprobs=True).start()
    try:
        return _run(b)
    finally:
        b.stop()


@pytest.mark.parametrize("impl", ["gather", "paged_kernel"])
def test_greedy_streams_byte_identical(reference, impl):
    b = _port(attn_impl=impl, logprobs=True).start()
    try:
        streams, lps = _run(b)
    finally:
        b.stop()
    ref_streams, ref_lps = reference
    assert streams == ref_streams
    assert [len(s) for s in streams] == [n for _, n in REQUESTS]
    for got, ref in zip(lps, ref_lps):
        np.testing.assert_allclose(got, ref, atol=1e-4)
    assert b.admission_paths["paged_shared"] >= 1
    # Every block is allocatable again (free or refcount-0 cached).
    assert sorted(b._free_blocks) == list(range(1, BLOCKS))


def test_sampled_requests_repeat_per_seed():
    b = _port().start()
    try:
        prompt = REQUESTS[3][0]
        kw = dict(max_new_tokens=10, temperature=0.9)
        a = b.submit(prompt, seed=5, **kw).result()
        again = b.submit(prompt, seed=5, **kw).result()
        other = b.submit(prompt, seed=6, **kw).result()
        nucleus = b.submit(prompt, seed=5, top_p=0.5, **kw).result()
    finally:
        b.stop()
    assert a == again
    for s in (a, other, nucleus):
        assert len(s) == 10 and all(0 <= t < 64 for t in s)
    assert sorted(b._free_blocks) == list(range(1, BLOCKS))


@pytest.mark.parametrize("top_p", [0.0, 0.7])
def test_sampling_distribution_matches_reference(top_p):
    """20000 draws of the port's sampler against the reference's warped
    distribution (temperature 0.7, optional nucleus): each token's
    frequency within 0.015 of its probability; masked tokens never."""
    logits = np.random.default_rng(2).standard_normal(8).astype(np.float32)
    warped = JaxEngine.warp_logits(
        jnp.asarray(logits), JaxSampling(temperature=0.7, top_p=top_p))
    probs = np.asarray(jax.nn.softmax(warped))
    scaled = nucleus_mask(torch.from_numpy(logits) / 0.7, top_p)
    gen = torch.Generator().manual_seed(0)
    draws = gumbel_sample(scaled.expand(20000, 8), gen).numpy()
    freq = np.bincount(draws, minlength=8) / draws.size
    np.testing.assert_allclose(freq, probs, atol=0.015)
    assert (freq[probs == 0] == 0).all()


def test_overloaded_at_max_pending():
    b = _port(max_pending=2)          # not started: nothing drains
    b.submit([1, 2, 3])
    b.submit([4, 5])
    with pytest.raises(Overloaded):
        b.submit([6])


_TOKS = [str(i) for i in range(DIMS["vocab_size"])]


@pytest.mark.parametrize("kw,raises", [
    # Adapters and constraints are ported: each case holds the
    # reference's behaviour for its arguments; a mesh beyond dp and tp
    # (here ep 2) still raises.
    pytest.param(dict(draft="ngram", eos_id=0, constraints=ConstraintBank(
        {"d": "[0-9]+"}, _TOKS)), ValueError, id="kw0"),
    pytest.param(dict(adapters={}), None, id="kw1"),
    pytest.param(dict(constraints=ConstraintBank({}, _TOKS)), None,
                 id="kw2"),
    pytest.param(dict(mesh=SimpleNamespace(
        mesh_dim_names=("dp", "pp", "ep", "sp", "tp"),
        mesh=np.zeros((1, 1, 2, 1, 1)))), NotImplementedError, id="kw3"),
])
def test_unported_options_raise(kw, raises):
    args = dict(slots=2, paged_blocks=BLOCKS, page_size=PAGE, device="cpu")
    args.update(kw)
    if raises is not None:
        with pytest.raises(raises):
            ContinuousBatcher(TM, TP, **args)
        return
    # An empty bank serves as the base model: the bank-less stream.
    prompt, n = REQUESTS[2]
    streams = []
    for b in (ContinuousBatcher(TM, TP, **args), _port()):
        b.start()
        try:
            streams.append(b.submit(prompt, max_new_tokens=n).result())
        finally:
            b.stop()
    assert streams[0] == streams[1] and len(streams[0]) == n
