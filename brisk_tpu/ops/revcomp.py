"""Reverse-complement and canonicalization kernels.

Two variants, matching the reference exactly:

* rcb64 (reference rcbc, Kmers.cpp:320-332): TRUE reverse complement of an
  n<=32 base value — complement, byte swap, nibble/2-bit swizzles, realign.
* rcb128_broken (reference rcb, Kmers.cpp:293-316): the 128-bit variant
  whose SSE byte-swap result is DISCARDED (Kmers.cpp:304) — only in-byte
  nucleotide reversal happens. Feeds only the canonized() strand test used
  by get_minimizer's equal-distance tie-break (Kmers.cpp:399). Replicated
  bit-for-bit; do not "fix".
"""

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from brisk_tpu.ops import u128

# numpy scalars, NOT jnp: module-level jnp constants become device arrays
# that get embedded as jaxpr constants and re-materialized (device->host)
# at every lowering.
U32 = np.uint32
_C1 = U32(0x0F0F0F0F)
_C2 = U32(0x33333333)
_COMP = U32(0xAAAAAAAA)


def _swizzle_byte_local(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 4 nucleotides within every byte and complement."""
    x = ((x & _C1) << U32(4)) | ((x & (_C1 << U32(4))) >> U32(4))
    x = ((x & _C2) << U32(2)) | ((x & (_C2 << U32(2))) >> U32(2))
    return x ^ _COMP


def _bswap32(x: jnp.ndarray) -> jnp.ndarray:
    return ((x << U32(24))
            | ((x & U32(0xFF00)) << U32(8))
            | ((x >> U32(8)) & U32(0xFF00))
            | (x >> U32(24)))


def rcb64(lo: jnp.ndarray, hi: jnp.ndarray, n: int
          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """True reverse complement of n<=32 bases held in 2 limbs."""
    # complement+swizzle each limb, byte-swap the 64-bit word (swap limbs
    # and bytes within each)
    new_lo = _swizzle_byte_local(_bswap32(hi))
    new_hi = _swizzle_byte_local(_bswap32(lo))
    return u128.shr((new_lo, new_hi), 64 - 2 * n)


def canonize64(lo: jnp.ndarray, hi: jnp.ndarray, n: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """min(x, rcb64(x)) — canonical m-mer (reference Kmers.cpp:336-338)."""
    rc = rcb64(lo, hi, n)
    return u128.minimum((lo, hi), rc)


def rcb128_broken(limbs: u128.Limbs, n: int) -> u128.Limbs:
    """The reference's 128-bit RC with its no-op byte swap: per-limb in-byte
    swizzle + complement (NO byte or limb reversal), then realign right by
    128-2n bits."""
    swz = tuple(_swizzle_byte_local(l) for l in limbs)
    return u128.shr(swz, 128 - 2 * n)


def canonized_k(kmer: u128.Limbs, k: int) -> jnp.ndarray:
    """Strand test x <= broken_rc(x) (reference canonized, Kmers.cpp:348)."""
    return u128.le(kmer, rcb128_broken(kmer, k))
