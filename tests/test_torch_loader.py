"""The port's ``TokenLoader`` gives the reference's batches byte for
byte, through its Python backend and the native prefetcher: same
permutation, shards, epoch rollover and shift; the native tokenizer gives
the reference's ids under both of the reference's backends."""

import time

import numpy as np
import pytest

from k8s_gpu_tpu.data import TokenLoader as JaxTokenLoader
from k8s_gpu_tpu.data import loader as jax_loader
from k8s_gpu_tpu.data.loader import epoch_permutation as jax_permutation
from k8s_gpu_tpu.data.tokenizer import BpeTokenizer as JaxTokenizer
from k8s_gpu_tpu_torch.data import native
from k8s_gpu_tpu_torch.data.loader import (
    TokenLoader, epoch_permutation, write_tokens,
)
from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer

SEQ, BATCH = 8, 4
# How long a test waits for the reference's native library to load.
NATIVE_WAIT_S = 120.0


@pytest.fixture(scope="module")
def reference_native():
    """The reference's native library, loaded.  Each test process builds
    it with ``make`` at first use, and ``make`` links straight onto
    ``native/build/libk8sgputpu.so``: a process that arrives while
    another is linking finds a fresh, half-written file, ``make`` does
    nothing, the load fails and the reference caches the failure for the
    life of the process.  So retry the load, clearing that cache between
    tries, until it succeeds or ``NATIVE_WAIT_S`` runs out."""
    deadline = time.monotonic() + NATIVE_WAIT_S
    while True:
        lib = jax_loader._load_native()
        if lib is not None:
            return lib
        if time.monotonic() > deadline:
            pytest.fail("the reference's native library did not load within "
                        f"{NATIVE_WAIT_S:.0f} s (make -C native failed?)")
        jax_loader._lib_tried = False
        time.sleep(0.5)


@pytest.fixture
def token_file(tmp_path):
    # 43 samples of SEQ + 1 tokens and a ragged tail.
    rng = np.random.default_rng(0)
    return write_tokens(tmp_path / "toks.bin",
                        rng.integers(0, 50_000, 43 * (SEQ + 1) + 5))


@pytest.mark.parametrize("shard,shuffle,seed", [
    ((0, 1), True, 0), ((1, 3), True, 7), ((0, 2), False, 0),
])
def test_batches_match_reference_byte_for_byte(token_file, shard, shuffle,
                                               seed):
    kw = dict(shard=shard, seed=seed, shuffle=shuffle)
    with JaxTokenLoader(token_file, SEQ, BATCH, backend="python",
                        **kw) as ref, TokenLoader(token_file, SEQ, BATCH,
                                                  **kw) as got:
        assert got.batches_per_epoch == ref.batches_per_epoch
        for _ in range(2 * ref.batches_per_epoch + 1):   # two rollovers
            (rx, ry), (gx, gy) = next(ref), next(got)
            assert got.epoch == ref.epoch
            for r, g in ((rx, gx), (ry, gy)):
                assert g.dtype == r.dtype and g.shape == (BATCH, SEQ)
                assert g.tobytes() == r.tobytes()


def test_permutation_matches_reference():
    for n, seed, epoch in ((1, 0, 0), (17, 3, 2), (200, 2 ** 40, 5)):
        np.testing.assert_array_equal(epoch_permutation(n, seed, epoch),
                                      jax_permutation(n, seed, epoch))


def test_native_backend_and_small_shard_raise(token_file):
    with TokenLoader(token_file, SEQ, BATCH, backend="native") as nat, \
            TokenLoader(token_file, SEQ, BATCH, backend="python") as py:
        assert nat.backend == "native" and py.backend == "python"
        (nx, ny), (px, py_) = next(nat), next(py)
        assert nx.tobytes() == px.tobytes() and ny.tobytes() == py_.tobytes()
    with pytest.raises(ValueError, match="one batch"):
        TokenLoader(token_file, SEQ, 64)
    with pytest.raises(ValueError, match="one batch"):
        TokenLoader(token_file, SEQ, 64, backend="native")


@pytest.mark.parametrize("shard,shuffle,seed,threads", [
    ((0, 1), True, 0, 1), ((1, 3), True, 7, 2), ((0, 2), False, 0, 4),
])
def test_native_batches_match_reference_byte_for_byte(reference_native,
                                                      token_file, shard,
                                                      shuffle, seed,
                                                      threads):
    """The native prefetcher, on any number of threads, against the
    reference's native and Python backends, over two epoch rollovers."""
    kw = dict(shard=shard, seed=seed, shuffle=shuffle)
    with JaxTokenLoader(token_file, SEQ, BATCH, backend="native", **kw) as rn, \
            JaxTokenLoader(token_file, SEQ, BATCH, backend="python",
                           **kw) as rp, \
            TokenLoader(token_file, SEQ, BATCH, backend="native",
                        n_threads=threads, **kw) as got:
        assert got.batches_per_epoch == rp.batches_per_epoch
        for _ in range(2 * rp.batches_per_epoch + 1):
            (nx, ny), (px, py), (gx, gy) = next(rn), next(rp), next(got)
            assert got.epoch == rp.epoch == rn.epoch
            for g, r, p in ((gx, nx, px), (gy, ny, py)):
                assert g.dtype == np.int32 and g.shape == (BATCH, SEQ)
                assert g.tobytes() == r.tobytes() == p.tobytes()


def test_native_unavailable_raises_and_auto_falls_back(token_file,
                                                       monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "RuntimeError: g++ failed")
    with pytest.raises(RuntimeError, match="native library unavailable"):
        TokenLoader(token_file, SEQ, BATCH, backend="native")
    with pytest.raises(RuntimeError, match="native library unavailable"):
        BpeTokenizer([], backend="native")
    with TokenLoader(token_file, SEQ, BATCH) as auto:
        assert auto.backend == "python"
    assert BpeTokenizer([]).backend == "python"


TEXT = ("the quick brown fox jumps over the lazy dog; "
        "pack my box with five dozen liquor jugs. ") * 6 + "\u00e9t\u00e9 \u2603"


@pytest.mark.parametrize("vocab", [256, 300, 400])
def test_native_tokenizer_ids_match_reference(reference_native, vocab):
    nat = BpeTokenizer.train(TEXT, vocab, backend="native")
    py = BpeTokenizer.train(TEXT, vocab, backend="python")
    ref_n = JaxTokenizer.train(TEXT, vocab, backend="native")
    ref_p = JaxTokenizer.train(TEXT, vocab, backend="python")
    assert nat.backend == "native" and py.backend == "python"
    assert nat.merges == py.merges == ref_n.merges == ref_p.merges
    probe = TEXT[7:90] + " unseen words \u2603"
    ids = nat.encode(probe)
    for other in (py, ref_n, ref_p):
        assert ids.dtype == np.int32
        assert ids.tobytes() == other.encode(probe).tobytes()
    assert nat.decode(ids) == py.decode(ids) == probe
    assert nat.encode("").size == 0
    with pytest.raises(ValueError, match="outside"):
        nat.decode([vocab + 5])
