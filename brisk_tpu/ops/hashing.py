"""Vectorized invertible minimizer hash (reference hashing.cpp:8-49).

bfc_hash_64 is a Thomas-Wang style mixer masked to 2m bits, with the
decycling class planted in bits 62-63 (hashing.cpp:17). The 64-bit
key lives in two uint32 limbs (ops/u128); for m <= 16 the whole mix fits
one uint32 limb because every masked step satisfies (x mod 2^64) & mask ==
(x mod 2^32) & mask when mask < 2^32.

Hash totals are ordered as the reference's uint64 (heavy << 62) + key:
comparisons use the (heavy, hi, lo) lexicographic triple since key < 2^62.

The inverse hash (hashing.cpp:23-49) requires 64-bit multiplies and is only
needed host-side (un-hashing minimizers for enumeration/export); it lives
in brisk_tpu.oracle.pyref (scalar) and numpy (batch) in index/unhash.
"""

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from brisk_tpu.ops import decycling, u128

U32 = np.uint32  # numpy scalar: avoids device-constant embedding at trace time
HashTriple = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]  # (heavy, hi, lo)


def _mix64(lo: jnp.ndarray, hi: jnp.ndarray, m: int
           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The masked mixing pipeline on a 2-limb key, mask = 2^(2m)-1."""
    key = (lo, hi)

    def mask(v):
        return u128.mask_bits(v, 2 * m)

    # key = (~key + (key << 21)) & mask
    key = mask(u128.add(u128.bnot(key), u128.shl(key, 21)))
    # key ^= key >> 24
    key = u128.bxor(key, u128.shr(key, 24))
    # key = (key + (key << 3) + (key << 8)) & mask
    key = mask(u128.add(u128.add(key, u128.shl(key, 3)), u128.shl(key, 8)))
    key = u128.bxor(key, u128.shr(key, 14))
    key = mask(u128.add(u128.add(key, u128.shl(key, 2)), u128.shl(key, 4)))
    key = u128.bxor(key, u128.shr(key, 28))
    key = mask(u128.add(key, u128.shl(key, 31)))
    return key


def _mix32(lo: jnp.ndarray, m: int) -> jnp.ndarray:
    """Single-limb fast path for m <= 16 (mask < 2^32): uint32 overflow
    matches the reference's mod-2^64-then-mask arithmetic."""
    mask = U32((1 << (2 * m)) - 1) if m < 16 else U32(0xFFFFFFFF)
    key = lo
    key = (~key + (key << U32(21))) & mask
    key = key ^ (key >> U32(24))
    key = ((key + (key << U32(3))) + (key << U32(8))) & mask
    key = key ^ (key >> U32(14))
    key = ((key + (key << U32(2))) + (key << U32(4))) & mask
    key = key ^ (key >> U32(28))
    key = (key + (key << U32(31))) & mask
    return key


def mix_key(mmer_lo: jnp.ndarray, mmer_hi: jnp.ndarray, m: int
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The 2m-bit mixed key only (no decycling class): this is what gets
    written into stored k-mers (replace_slice masks to 2m bits, dropping
    the heavy bits — Kmers.cpp:149-159,191-200) and what bucket ids are
    derived from (the heavy bits at 62-63 can never reach the 2b bucket
    bits for b <= 15). Returns (hi, lo)."""
    if m <= 16:
        lo = _mix32(mmer_lo, m)
        hi = jnp.zeros_like(lo)
    else:
        lo, hi = _mix64(mmer_lo, mmer_hi, m)
    return hi, lo


def bfc_hash(mmer_lo: jnp.ndarray, mmer_hi: jnp.ndarray, m: int
             ) -> HashTriple:
    """Hash of canonical m-mers: returns (heavy, hi, lo) where heavy is the
    decycling class (2 bits) and (hi, lo) the 2m-bit mixed key."""
    heavy = decycling.mem_double(mmer_lo, mmer_hi, m)
    hi, lo = mix_key(mmer_lo, mmer_hi, m)
    return heavy, hi, lo


def hash_lt(a: HashTriple, b: HashTriple) -> jnp.ndarray:
    """(heavy<<62)+key comparison as lexicographic (heavy, hi, lo)."""
    return jnp.where(
        a[0] != b[0], a[0] < b[0],
        jnp.where(a[1] != b[1], a[1] < b[1], a[2] < b[2]))


def hash_eq(a: HashTriple, b: HashTriple) -> jnp.ndarray:
    return (a[0] == b[0]) & (a[1] == b[1]) & (a[2] == b[2])


def hash_select(pred, a: HashTriple, b: HashTriple) -> HashTriple:
    return tuple(jnp.where(pred, x, y) for x, y in zip(a, b))
