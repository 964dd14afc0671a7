"""Parity tests for the J-major span expansion against the row-major
reference expansion (_expand_span). Contract: for every word w, row r
and slot j,  jmajor[w, j*R + r] == rowmajor[w, r*s_max + j]. The same
comparison runs on the GPU at R = 2^23 in chip_smoke.py (phase b).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from brisk_tpu.index import sklstore, store
from tests.make_synth_fasta import random_span

K, M, B = 31, 11, 8


def _rowmajor_as_jmajor(keys_rm, R, s_max):
    W = keys_rm.shape[0]
    k3 = np.asarray(keys_rm).reshape(W, R, s_max)
    return np.moveaxis(k3, 2, 1).reshape(W, s_max * R)


@pytest.mark.parametrize("R", [1024, 4096, 12288])
def test_lax_jmajor_matches_rowmajor(R):
    sb, sm, sn, s_max = random_span(R, K, M, B, seed=R)
    keys_rm, _ = sklstore._expand_span(sb, sm, sn, K, M, B, s_max)
    keys_jm = sklstore._expand_span_jmajor(sb, sm, sn, K, M, B, s_max)
    want = _rowmajor_as_jmajor(keys_rm, R, s_max)
    np.testing.assert_array_equal(np.asarray(keys_jm), want)


def test_make_key_words_matches_make_keys():
    rng = np.random.default_rng(3)
    N = 257
    bucket = jnp.asarray(rng.integers(0, 1 << 16, N, dtype=np.uint32))
    limbs = jnp.asarray(rng.integers(0, 1 << 32, (4, N), dtype=np.uint32))
    mini = jnp.asarray(rng.integers(0, 40, N, dtype=np.uint32))
    stacked = store.make_keys(bucket, limbs, mini, K, B)
    words = store.make_key_words(bucket, limbs, mini, K, B)
    np.testing.assert_array_equal(np.asarray(stacked),
                                  np.asarray(jnp.stack(words)))
