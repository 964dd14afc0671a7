"""Generic fixed-width DATA payloads — the array-program `Brisk<DATA>`
(reference Brisk.hpp:23-42: the index is templated on an arbitrary
per-k-mer payload type; the counter instantiates DATA = uint8 count).

Here a payload is D uint32 lanes per entry with a STATIC per-lane merge
kind applied when duplicate keys consolidate:

  "sum"   — lanes that accumulate (counts; uint32 wrap like the
            reference's uint8 wrap, counter.cpp:262-269)
  "max"   — monotone maxima (e.g. last position when positions ascend)
  "min"   — monotone minima (e.g. first position)

The reference merges duplicates under a mutex with user code mutating
`DATA*` in place (Brisk.hpp:63-69 get + caller update). The functional
Array analog: duplicates are merged in compaction by a SEGMENTED
associative scan per lane — any associative, commutative-up-to-order
merge expressible per lane runs as one fused device pass over the sorted
run. Layout and machinery mirror index.store (packed lexicographic keys,
log-structured sorted run + unsorted tail); store.IndexState is the
D == 1, kinds == ("sum",) special case kept separate for the counter's
hot path.
"""

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from brisk_tpu.index import store

U32 = np.uint32
_INVALID = U32(0xFFFFFFFF)

KINDS = ("sum", "max", "min")


class PayloadState(NamedTuple):
    keys: jnp.ndarray      # (W, cap) uint32 packed keys (store.make_keys)
    data: jnp.ndarray      # (D, cap) uint32 payload lanes
    n_sorted: jnp.ndarray  # () int32
    n_used: jnp.ndarray    # () int32


def empty(capacity: int, nkey: int, width: int) -> PayloadState:
    return PayloadState(
        keys=jnp.full((nkey, capacity), _INVALID, dtype=U32),
        data=jnp.zeros((width, capacity), dtype=U32),
        n_sorted=jnp.int32(0), n_used=jnp.int32(0))


def grow(state: PayloadState, new_capacity: int) -> PayloadState:
    cap = state.keys.shape[1]
    assert new_capacity > cap
    pad = new_capacity - cap
    return PayloadState(
        keys=jnp.pad(state.keys, ((0, 0), (0, pad)),
                     constant_values=_INVALID),
        data=jnp.pad(state.data, ((0, 0), (0, pad))),
        n_sorted=state.n_sorted, n_used=state.n_used)


def ensure_room(state: PayloadState, n_incoming: int) -> PayloadState:
    cap = state.keys.shape[1]
    while int(state.n_used) + n_incoming > cap:
        cap *= 2
        state = grow(state, cap)
    return state


@jax.jit
def append(state: PayloadState, keys: jnp.ndarray, values: jnp.ndarray,
           valid: jnp.ndarray) -> PayloadState:
    """Append (W, N) keys with (D, N) payload rows to the unsorted log
    (same contiguous-slice contract as store.append: invalid rows become
    INVALID tombstones; n_used counts raw slots)."""
    n = keys.shape[1]
    keys_w = jnp.where(valid[None, :], keys, _INVALID)
    vals_w = jnp.where(valid[None, :], values, 0)
    return PayloadState(
        keys=jax.lax.dynamic_update_slice(state.keys, keys_w,
                                          (jnp.int32(0), state.n_used)),
        data=jax.lax.dynamic_update_slice(state.data, vals_w,
                                          (jnp.int32(0), state.n_used)),
        n_sorted=state.n_sorted, n_used=state.n_used + n)


def _seg_combine(kind: str):
    if kind == "sum":
        f = jnp.add
    elif kind == "max":
        f = jnp.maximum
    elif kind == "min":
        f = jnp.minimum
    else:
        raise ValueError(f"unknown merge kind {kind!r} (use one of {KINDS})")

    def op(a, b):  # b is to the RIGHT of a; flags mark segment starts
        va, fa = a
        vb, fb = b
        return jnp.where(fb, vb, f(va, vb)), fa | fb
    return op


@partial(jax.jit, static_argnames=("kinds",))
def compact(state: PayloadState, kinds: Tuple[str, ...]) -> PayloadState:
    """Global sort + duplicate merge: per payload lane, duplicates of a
    key reduce under that lane's kind via a segmented associative scan
    (the generalization of store.compact's cumsum-difference, which only
    handles sums)."""
    assert len(kinds) == state.data.shape[0]
    cap = state.keys.shape[1]
    in_use = jnp.arange(cap) < state.n_used
    keys = jnp.where(in_use[None, :], state.keys, _INVALID)
    data = jnp.where(in_use[None, :], state.data, 0)
    nk = keys.shape[0]
    ops = tuple(keys[i] for i in range(nk)) + tuple(
        data[d] for d in range(data.shape[0]))
    out = jax.lax.sort(ops, num_keys=nk)
    keys = jnp.stack(out[:nk])
    lanes = out[nk:]

    first = ~jnp.all(keys == jnp.roll(keys, 1, axis=1), axis=0)
    first = first.at[0].set(True)
    valid = keys[0] != _INVALID
    is_last = jnp.roll(first, -1, axis=0).at[-1].set(True)

    # per-lane segmented reduce: the scan leaves each segment's reduction
    # on its LAST column
    reduced = []
    for lane, kind in zip(lanes, kinds):
        v, _ = jax.lax.associative_scan(_seg_combine(kind), (lane, first))
        reduced.append(jnp.where(is_last, v, 0))

    # move each segment's reduction from its LAST column to its FIRST:
    # both firsts and lasts enumerate segments in the same order, so one
    # packing sort aligns them (same trick as store.compact)
    n_seg_ids = jnp.cumsum(first) - 1
    big = jnp.uint32(0x7FFFFFFF)
    rank_first = jnp.where(first, n_seg_ids.astype(U32), big)
    rank_last = jnp.where(is_last, n_seg_ids.astype(U32), big)
    packed = jax.lax.sort((rank_first,) + tuple(keys[i] for i in range(nk)),
                          num_keys=1)
    packed_vals = jax.lax.sort((rank_last,) + tuple(reduced), num_keys=1)
    keys_u = jnp.stack(packed[1:])
    data_u = jnp.stack(packed_vals[1:])
    n_unique = jnp.sum(first & valid).astype(jnp.int32)
    keep = jnp.arange(cap) < n_unique
    return PayloadState(
        keys=jnp.where(keep[None, :], keys_u, _INVALID),
        data=jnp.where(keep[None, :], data_u, 0),
        n_sorted=n_unique, n_used=n_unique)


@jax.jit
def lookup(state: PayloadState, keys: jnp.ndarray
           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(W, Q) packed keys -> (found (Q,) bool, values (D, Q)); callers
    compact first (binary search over the sorted region, gathering all D
    payload lanes at the hit position)."""
    cap = state.keys.shape[1]
    q = keys.shape[1]
    nk = keys.shape[0]
    lo = jnp.zeros((q,), dtype=jnp.int32)
    hi = jnp.broadcast_to(state.n_sorted, (q,)).astype(jnp.int32)
    steps = int(np.ceil(np.log2(max(cap, 2)))) + 1

    def key_lt(a, b):
        lt = a[0] < b[0]
        eqs = a[0] == b[0]
        for i in range(1, nk):
            lt = lt | (eqs & (a[i] < b[i]))
            eqs = eqs & (a[i] == b[i])
        return lt

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        go_right = key_lt(state.keys[:, mid], keys)
        return (jnp.where(go_right, mid + 1, lo),
                jnp.where(go_right, hi, mid))

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    pos = jnp.clip(lo, 0, cap - 1)
    found = jnp.all(state.keys[:, pos] == keys, axis=0) & \
        (lo < state.n_sorted)
    vals = jnp.where(found[None, :], state.data[:, pos], 0)
    return found, vals
