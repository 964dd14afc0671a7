"""Dynamic index growth: re-key every stored entry under new (m, b).

The array-program equivalent of Brisk::reallocate (Brisk.hpp:202-224):
the reference walks its cursor over every k-mer, re-runs get_minimizer
with m+2 and re-inserts into a fresh DenseMenuYo. Here the walk is a
single batched device pass: stored hashed keys are un-hashed host-side
(vectorized), the k-mers are laid out one-per-lane, and the new
minimizer decomposition is one windowed_get_minimizer evaluation at the
final position of each lane (exactly update_kmer's
get_minimizer-on-the-value semantics, Brisk.hpp:88-97 — NOT the
streaming enumerator).

Deviation from the reference, documented: when two old entries collapse to
one new key (same k-mer value stored under two old minimizer keys), the
reference's `*value = *old_value` keeps whichever entry its cursor visits
last (Brisk.hpp:219). We SUM the payloads instead, which preserves
aggregate counts (counts_dict is invariant under reallocate).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from brisk_tpu.index import readout, store
from brisk_tpu.ops import enumerate as enum_ops
from brisk_tpu.ops import hashing, minimizer, u128
from brisk_tpu.params import Parameters

U32 = np.uint32  # numpy scalar: avoids device-constant embedding at trace time


def _codes_from_values(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    """(N,) u64 pairs -> (N, k) uint32 2-bit codes, leftmost base first."""
    n = hi.shape[0]
    codes = np.empty((n, k), dtype=np.uint32)
    for j in range(k):
        bit = 2 * (k - 1 - j)
        if bit >= 64:
            codes[:, j] = ((hi >> np.uint64(bit - 64)) & np.uint64(3))
        else:
            codes[:, j] = ((lo >> np.uint64(bit)) & np.uint64(3))
    return codes


@partial(jax.jit, static_argnames=("k", "m", "b"))
def _rekey_batch(codes: jnp.ndarray, k: int, m: int, b: int):
    """codes (N, k) -> new (NKEY, N) keys under minimizer size m."""
    pa = minimizer.position_pipeline(codes, k, m)
    st = minimizer.windowed_get_minimizer(pa, pa.fwd_k, k, m)
    last = lambda limbs: tuple(l[:, -1] for l in limbs)
    kmer = last(pa.fwd_k)
    pos = st.pos[:, -1]
    rev = st.rev[:, -1]
    idx = jnp.where(rev, U32(k - m) - pos, pos)
    slice_mm = u128.mask_bits(u128.shr_var(kmer, idx * U32(2)), 2 * m)
    s_hi, s_lo = hashing.mix_key(slice_mm[0], slice_mm[1], m)
    key = enum_ops._hash_slice_replace(kmer, idx, s_hi, s_lo, m)
    bucket = enum_ops._bucket_id(s_hi, s_lo, m, b)
    return store.make_keys(bucket, u128.stack(key), idx, k, b)


def reindex(state: store.IndexState, old: Parameters, new: Parameters,
            batch: int = 1 << 16) -> store.IndexState:
    """Re-key all entries of a compacted state from `old` to `new`."""
    state = store.compact_auto(state)
    _, hi, lo, _, data = readout.entries_u64(state, old)
    n = hi.shape[0]
    out = store.empty(max(1 << 10, 1 << int(np.ceil(np.log2(max(n, 1) * 2)))),
                      store.key_words(new.k, new.b))
    for start in range(0, n, batch):
        end = min(start + batch, n)
        codes = _codes_from_values(hi[start:end], lo[start:end], new.k)
        rows = _rekey_batch(jnp.asarray(codes), k=new.k, m=new.m, b=new.b)
        out = store.ensure_room(out, rows.shape[1])
        out = store.append(out, rows, jnp.asarray(data[start:end]),
                           jnp.ones(rows.shape[1], dtype=bool))
    return store.compact_auto(out)
