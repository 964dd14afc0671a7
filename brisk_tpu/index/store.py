"""Functional sorted-array k-mer index (the array-program DenseMenuYo/Bucket).

The reference stores each bucket as realloc'd arrays of compacted
super-k-mers with a sorted prefix + unsorted tail, merged under OpenMP
locks (buckets.hpp:166-189, DenseMenuYo.hpp). Here the whole index is a
single immutable pytree of flat arrays — a log-structured merge state:

  * keys: (W, cap) uint32 — PACKED lexicographic key per stored k-mer
    entry: the bit-field concatenation
        bucket(2b bits) | hashed_kmer(2k bits) | mini_idx(8 bits)
    laid out big-endian over W = key_words(k, b) words, so plain word-wise
    lexicographic order equals (bucket, hashed kmer, mini_idx) order. The
    hashed k-mer has its minimizer slice replaced by its 2m-bit hash —
    identical identity to the reference's per-bucket compacted match (see
    SURVEY §2 C8/C9: bucket id + compacted value + alignment <=>
    (hashed k-mer, minimizer_idx)). Packing shrinks the flagship config
    (k=31, b=8) from 6 to 3 key words: less memory and a ~1.6x faster
    compaction sort. One spare top bit is always reserved so the all-ones
    INVALID sentinel is unreachable by real rows.
  * data: (cap,) uint32 payload per entry (counts for the counter app; the
    generic DATA story keeps a parallel array pytree).
  * n_sorted: entries [0, n_sorted) are sorted+deduped; [n_sorted, n_used)
    are a raw unsorted log appended by insert batches (the reference's
    unsorted tail, buckets.hpp:166).

All operations are pure jitted functions state -> state'; "growth" doubles
capacity host-side (outside jit), which retriggers compilation only per
capacity (powers of two).

Count semantics: inserts append (key, 1) rows; compaction segment-sums
duplicates. Counts are accumulated in uint32 and reduced mod 256 only at
read-out, matching the reference's uint8 wrap (counter.cpp:262-269).
"""

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

U32 = np.uint32  # numpy scalar: avoids device-constant embedding at trace time


def key_words(k: int, b: int) -> int:
    """#u32 words of a packed key: bucket(2b) | kmer(2k) | mini_idx(8),
    plus one reserved top bit (INVALID sentinel headroom)."""
    return -(-(2 * b + 2 * k + 8 + 1) // 32)


class IndexState(NamedTuple):
    keys: jnp.ndarray      # (W, cap) uint32 packed keys (big-endian words)
    data: jnp.ndarray      # (cap,) uint32
    n_sorted: jnp.ndarray  # () int32
    n_used: jnp.ndarray    # () int32


def empty(capacity: int, nkey: int) -> IndexState:
    return IndexState(
        keys=jnp.full((nkey, capacity), 0xFFFFFFFF, dtype=U32),
        data=jnp.zeros((capacity,), dtype=U32),
        n_sorted=jnp.int32(0),
        n_used=jnp.int32(0))


def grow(state: IndexState, new_capacity: int) -> IndexState:
    """Host-side capacity doubling (pure reshape, no recompute)."""
    cap = state.keys.shape[1]
    assert new_capacity > cap
    pad = new_capacity - cap
    return IndexState(
        keys=jnp.pad(state.keys, ((0, 0), (0, pad)),
                     constant_values=np.uint32(0xFFFFFFFF)),
        data=jnp.pad(state.data, (0, pad)),
        n_sorted=state.n_sorted, n_used=state.n_used)


def _deposit(limbs, word, bitpos: int):
    """OR (word << bitpos) into little-endian u32 limbs (static bitpos)."""
    n = len(limbs)
    out = list(limbs)
    w, bit = divmod(bitpos, 32)
    if w < n:
        out[w] = out[w] | (word << U32(bit) if bit else word)
    if bit and w + 1 < n:
        out[w + 1] = out[w + 1] | (word >> U32(32 - bit))
    return out


def make_key_words(bucket: jnp.ndarray, key_limbs,
                   mini_idx: jnp.ndarray, k: int, b: int) -> list:
    """make_keys without the final stack: big-endian LIST of W word
    arrays (key_limbs may be a (4, N) array or a 4-tuple). The list form
    lets callers stack words in the layout they need instead of
    materializing one stacked array first."""
    W = key_words(k, b)
    zeros = jnp.zeros_like(bucket)
    words = [zeros] * W  # little-endian while building
    words = _deposit(words, mini_idx, 0)
    for j in range(4):
        if 32 * j < 2 * k:
            words = _deposit(words, key_limbs[j], 8 + 32 * j)
    words = _deposit(words, bucket, 8 + 2 * k)
    return words[::-1]


def make_keys(bucket: jnp.ndarray, key_limbs: jnp.ndarray,
              mini_idx: jnp.ndarray, k: int, b: int) -> jnp.ndarray:
    """Pack (bucket, hashed-kmer limbs (4, N) little-endian, mini_idx)
    into (W, N) big-endian-ordered sort-key words."""
    return jnp.stack(make_key_words(bucket, key_limbs, mini_idx, k, b))


def bucket_of(rows: jnp.ndarray, k: int, b: int) -> jnp.ndarray:
    """Extract the bucket id from packed key rows (W, N)."""
    W = rows.shape[0]
    w, bit = divmod(8 + 2 * k, 32)  # little-endian word/bit of bucket LSB
    le = rows[::-1]
    v = le[w] >> U32(bit) if bit else le[w]
    if bit and w + 1 < W:
        v = v | (le[w + 1] << U32(32 - bit))
    return v & U32((1 << (2 * b)) - 1)


def pack_key_np(bucket: int, hashed_kmer: int, mini_idx: int, k: int,
                b: int) -> np.ndarray:
    """Host-side single-key packing (for scalar queries/tests)."""
    W = key_words(k, b)
    v = (bucket << (2 * k + 8)) | (hashed_kmer << 8) | mini_idx
    return np.array([(v >> (32 * (W - 1 - w))) & 0xFFFFFFFF
                     for w in range(W)], dtype=np.uint32)


def unpack_keys_np(keys: np.ndarray, k: int, b: int):
    """Host-side vectorized unpack of (W, N) packed keys ->
    (bucket u32, hashed kmer (hi, lo) u64 pairs, mini_idx u32)."""
    W = keys.shape[0]
    le = keys[::-1].astype(np.uint64)
    mini_idx = (le[0] & np.uint64(0xFF)).astype(np.uint32)

    def bits(lo_bit: int, width: int) -> np.ndarray:
        """Extract a <=64-bit field as u64 (vectorized)."""
        out = np.zeros(keys.shape[1], dtype=np.uint64)
        for w in range(W):
            base = 32 * w
            if base + 32 <= lo_bit or base >= lo_bit + width:
                continue
            word = le[w]
            if base >= lo_bit:
                out |= word << np.uint64(base - lo_bit)
            else:
                out |= word >> np.uint64(lo_bit - base)
        if width < 64:
            out &= np.uint64((1 << width) - 1)
        return out

    kmer_lo = bits(8, min(64, 2 * k))
    kmer_hi = bits(72, max(0, 2 * k - 64)) if 2 * k > 64 else \
        np.zeros(keys.shape[1], dtype=np.uint64)
    bucket = bits(8 + 2 * k, 2 * b).astype(np.uint32)
    return bucket, kmer_hi, kmer_lo, mini_idx


_INVALID = U32(0xFFFFFFFF)


def _lex_sort(keys: jnp.ndarray, *payloads):
    """Sort columns of (W, N) lexicographically, carrying payloads."""
    nk = keys.shape[0]
    ops = tuple(keys[i] for i in range(nk)) + tuple(payloads)
    out = jax.lax.sort(ops, num_keys=nk)
    return jnp.stack(out[:nk]), out[nk:]


def _cols_eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=0)


@jax.jit
def append(state: IndexState, keys: jnp.ndarray, values: jnp.ndarray,
           valid: jnp.ndarray) -> IndexState:
    """Append a batch of (key, value) rows to the unsorted log as one
    contiguous slice write (no gathers/scatters).
    Invalid rows are written as INVALID tombstones that occupy log slots
    until the next compact, so ensure_room must be called with the RAW
    batch width. n_used counts raw slots."""
    n = keys.shape[1]
    keys_w = jnp.where(valid[None, :], keys, _INVALID)
    vals_w = jnp.where(valid, values, 0)
    new_keys = jax.lax.dynamic_update_slice(
        state.keys, keys_w, (jnp.int32(0), state.n_used))
    new_data = jax.lax.dynamic_update_slice(
        state.data, vals_w, (state.n_used,))
    return IndexState(new_keys, new_data, state.n_sorted,
                      state.n_used + n)


@jax.jit
def compact(state: IndexState) -> IndexState:
    """Global sort + duplicate segment-sum: turns the whole state into one
    sorted deduped run (the array analog of insert_buffer's sort +
    inplace_merge, buckets.hpp:166-189)."""
    cap = state.keys.shape[1]
    in_use = jnp.arange(cap) < state.n_used
    keys = jnp.where(in_use[None, :], state.keys, _INVALID)
    data = jnp.where(in_use, state.data, 0)
    keys, (data,) = _lex_sort(keys, data)
    # Duplicate runs collapse into their first column. Invalid columns
    # (all-0xFFFFFFFF; a real bucket is < 4^15) sort to the end as one
    # trailing segment. Per-segment totals via difference of inclusive
    # prefix sums at segment boundaries (no scatter):
    #   total(seg [a,b]) = csum[b] - (csum[a] - data[a])
    first = ~_cols_eq(keys, jnp.roll(keys, 1, axis=1))
    first = first.at[0].set(True)
    valid = keys[0] != _INVALID
    # uint32 wraparound in csum is harmless: segment totals are computed
    # as differences mod 2^32, which are exact
    csum = jnp.cumsum(data, dtype=jnp.uint32)
    # propagate each segment's base to its last column via cummax (bases
    # are nondecreasing over firsts since csum is nondecreasing)
    seg_base = jax.lax.cummax(jnp.where(first, csum - data, U32(0)))
    is_last = jnp.roll(first, -1, axis=0).at[-1].set(True)
    seg_total = jnp.where(is_last, csum - seg_base, 0)
    # move each segment's total (sitting at its LAST column) to its FIRST
    # column: sort totals by segment rank of the last columns, and keys by
    # segment rank of the first columns — both orderings enumerate
    # segments 0..n_seg-1, so a single packing sort aligns them.
    n_seg_ids = jnp.cumsum(first) - 1  # segment rank per column
    big = jnp.uint32(0x7FFFFFFF)
    nk = keys.shape[0]
    rank_first = jnp.where(first, n_seg_ids.astype(U32), big)
    rank_last = jnp.where(is_last, n_seg_ids.astype(U32), big)
    packed = jax.lax.sort((rank_first,) + tuple(keys[i] for i in
                                                range(nk)), num_keys=1)
    packed_tot = jax.lax.sort((rank_last, seg_total), num_keys=1)
    keys_u = jnp.stack(packed[1:])
    data_u = packed_tot[1]
    n_unique = jnp.sum(first & valid).astype(jnp.int32)
    keep = jnp.arange(cap) < n_unique
    keys_final = jnp.where(keep[None, :], keys_u, _INVALID)
    data_final = jnp.where(keep, data_u, 0)
    return IndexState(keys_final, data_final, n_unique, n_unique)


@jax.jit
def compact_fast(state: IndexState) -> IndexState:
    """Sort + consolidate duplicate counts WITHOUT compressing: each
    duplicate run's total lands on its FIRST column; later duplicates stay
    in place as zero-data tombstone columns (reclaimed only by the full
    compact()). This skips compact()'s second packing sort — roughly
    halving compaction cost — at the price of dead columns when keys
    repeat across batches.

    Resulting contract: keys[:, :n_sorted] are sorted (duplicates
    adjacent); lookup()'s lower-bound lands on the first = consolidated
    column; readers must treat data == 0 columns as dead (a live entry's
    RAW count is >= 1; raw counts are uint32 and wrap only past 2^32).
    Idempotent: re-running keeps totals at firsts."""
    cap = state.keys.shape[1]
    in_use = jnp.arange(cap) < state.n_used
    keys = jnp.where(in_use[None, :], state.keys, _INVALID)
    data = jnp.where(in_use, state.data, 0)
    keys, (data,) = _lex_sort(keys, data)
    first = ~_cols_eq(keys, jnp.roll(keys, 1, axis=1))
    first = first.at[0].set(True)
    valid = keys[0] != _INVALID
    csum = jnp.cumsum(data, dtype=jnp.uint32)
    is_last = jnp.roll(first, -1, axis=0).at[-1].set(True)
    # nearest segment-last at/after each column via reverse cummin of the
    # (monotone, < 2^31 for any realistic capacity) csum at lasts
    last_csum = jax.lax.cummin(
        jnp.where(is_last, csum, U32(0xFFFFFFFF)), reverse=True)
    totals = jnp.where(first & valid, last_csum - (csum - data), 0)
    n_valid = jnp.sum(valid).astype(jnp.int32)
    return IndexState(keys, totals, n_valid, n_valid)


@jax.jit
def lookup(state: IndexState, keys: jnp.ndarray) -> Tuple[jnp.ndarray,
                                                          jnp.ndarray]:
    """Query values for (W, Q) packed keys against the SORTED region
    (callers compact first). Returns (found bool (Q,), values (Q,)).
    The binary search is a LOWER BOUND, so with duplicate-key tombstone
    runs it lands on the first (consolidated) entry."""
    cap = state.keys.shape[1]
    q = keys.shape[1]
    nk = keys.shape[0]
    # binary search per key column over the lexicographic order
    lo = jnp.zeros((q,), dtype=jnp.int32)
    hi = jnp.broadcast_to(state.n_sorted, (q,)).astype(jnp.int32)
    steps = int(np.ceil(np.log2(max(cap, 2)))) + 1

    def key_lt(a, b):
        # a, b: (W, Q). lexicographic a < b
        lt = a[0] < b[0]
        eqs = a[0] == b[0]
        for i in range(1, nk):
            lt = lt | (eqs & (a[i] < b[i]))
            eqs = eqs & (a[i] == b[i])
        return lt

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        mid_keys = state.keys[:, mid]
        go_right = key_lt(mid_keys, keys)
        return (jnp.where(go_right, mid + 1, lo),
                jnp.where(go_right, hi, mid))

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    pos = jnp.clip(lo, 0, cap - 1)
    found = _cols_eq(state.keys[:, pos], keys) & (lo < state.n_sorted)
    return found, jnp.where(found, state.data[pos], 0)


def ensure_room(state: IndexState, n_incoming: int) -> IndexState:
    """Host-side: grow (double) until the log can absorb n_incoming rows."""
    cap = state.keys.shape[1]
    while int(state.n_used) + n_incoming > cap:
        cap *= 2
        state = grow(state, cap)
    return state


@jax.jit
def _write_back(state: IndexState, sub_keys: jnp.ndarray,
                sub_data: jnp.ndarray, n: jnp.ndarray) -> IndexState:
    keys = jax.lax.dynamic_update_slice(state.keys, sub_keys,
                                        (jnp.int32(0), jnp.int32(0)))
    data = jax.lax.dynamic_update_slice(state.data, sub_data,
                                        (jnp.int32(0),))
    return IndexState(keys, data, n, n)


def compact_auto(state: IndexState, full: bool = True) -> IndexState:
    """Host-side compaction that sorts only a power-of-two prefix covering
    the used region instead of the whole capacity (a full-capacity sort
    can be a 67M-column sort for 33M used rows).
    Invariant relied on: columns >= n_used are INVALID keys with zero data
    (established by empty/grow/append/compact).

    full=False uses compact_fast (duplicates stay as zero-data tombstone
    columns — cheaper, preferred on the insert hot path)."""
    fn = compact if full else compact_fast
    cap = state.keys.shape[1]
    n = int(state.n_used)
    n2 = 1 << max(10, (max(n, 1) - 1).bit_length())
    if n2 >= cap:
        return fn(state)
    sub = fn(IndexState(state.keys[:, :n2], state.data[:n2],
                        state.n_sorted, state.n_used))
    return _write_back(state, sub.keys, sub.data, sub.n_sorted)
