"""The port's Python ``TokenLoader`` gives the reference's batches byte
for byte: same permutation, shards, epoch rollover and shift."""

import numpy as np
import pytest

from k8s_gpu_tpu.data import TokenLoader as JaxTokenLoader
from k8s_gpu_tpu.data.loader import epoch_permutation as jax_permutation
from k8s_gpu_tpu_torch.data.loader import (
    TokenLoader, epoch_permutation, write_tokens,
)

SEQ, BATCH = 8, 4


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TokenLoader(token_file, SEQ, BATCH, backend="native")
    with pytest.raises(ValueError, match="one batch"):
        TokenLoader(token_file, SEQ, 64)
