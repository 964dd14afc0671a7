"""Multi-limb unsigned integer arithmetic on uint32 lanes.

The design avoids 64-bit integer lanes (it was first built for a device
without them; whether native u64 on the H100 gives less code at equal
speed is ROADMAP D4), so k-mers (up to 126 bits,
reference `kint` = __uint128_t, Kmers.hpp:26) are represented as tuples of
uint32 "limbs", little-endian (limbs[0] = bits 0-31). m-mers and 64-bit
hash keys use 2 limbs; k-mers use 4.

All functions are shape-polymorphic: a "value" is a tuple of N equally
shaped uint32 arrays. Static shift helpers unroll at trace time; variable
shifts (needed for minimizer-slice surgery at a data-dependent position)
select over limb offsets.
"""

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

U32 = np.uint32  # numpy scalar: avoids device-constant embedding at trace time
Limbs = Tuple[jnp.ndarray, ...]

_M32 = (1 << 32) - 1


def from_scalar(value: int, n_limbs: int, like=None) -> Limbs:
    """Broadcast a Python int into limbs (shaped like `like` if given)."""
    out = []
    for i in range(n_limbs):
        w = (value >> (32 * i)) & _M32
        a = jnp.uint32(w)
        if like is not None:
            a = jnp.full(jnp.shape(like), w, dtype=U32)
        out.append(a)
    return tuple(out)


def to_python_int(limbs: Sequence) -> int:
    """Host-side: collapse limb arrays of scalars back to a Python int."""
    total = 0
    for i, l in enumerate(limbs):
        total |= int(l) << (32 * i)
    return total


def mask_bits(limbs: Limbs, nbits: int) -> Limbs:
    """Keep the low `nbits` bits (static)."""
    out = []
    for i, l in enumerate(limbs):
        lo = 32 * i
        if nbits <= lo:
            out.append(jnp.zeros_like(l))
        elif nbits >= lo + 32:
            out.append(l)
        else:
            out.append(l & U32((1 << (nbits - lo)) - 1))
    return tuple(out)


def shl(limbs: Limbs, s: int) -> Limbs:
    """Static left shift by s bits (result truncated to same limb count)."""
    n = len(limbs)
    words, bits = divmod(s, 32)
    out = []
    for i in range(n):
        v = jnp.zeros_like(limbs[0])
        src = i - words
        if 0 <= src < n:
            v = limbs[src] << U32(bits) if bits else limbs[src]
        if bits and 0 <= src - 1 < n:
            v = v | (limbs[src - 1] >> U32(32 - bits))
        out.append(v)
    return tuple(out)


def shr(limbs: Limbs, s: int) -> Limbs:
    """Static logical right shift by s bits."""
    n = len(limbs)
    words, bits = divmod(s, 32)
    out = []
    for i in range(n):
        v = jnp.zeros_like(limbs[0])
        src = i + words
        if 0 <= src < n:
            v = limbs[src] >> U32(bits) if bits else limbs[src]
        if bits and 0 <= src + 1 < n:
            v = v | (limbs[src + 1] << U32(32 - bits))
        out.append(v)
    return tuple(out)


def shl_var(limbs: Limbs, s: jnp.ndarray) -> Limbs:
    """Variable left shift: s is a uint32 array broadcastable to the limb
    shape, 0 <= s < 32*len(limbs). Implemented as a select over the limb
    offset plus an in-limb variable shift (elementwise shifts are native
    on the VPU)."""
    n = len(limbs)
    s = s.astype(U32)
    words = s >> U32(5)
    bits = s & U32(31)
    nz = bits != 0
    out = []
    for i in range(n):
        acc = jnp.zeros_like(limbs[0])
        for w in range(n):
            sel = words == U32(w)
            src = i - w
            v = jnp.zeros_like(limbs[0])
            if 0 <= src < n:
                v = limbs[src] << bits
            if 0 <= src - 1 < n:
                # (x >> (32-bits)) is undefined for bits==0; gate it
                carry = jnp.where(nz, limbs[src - 1] >> (U32(32) - bits),
                                  jnp.zeros_like(limbs[0]))
                v = v | carry
            acc = jnp.where(sel, v, acc)
        out.append(acc)
    return tuple(out)


def shr_var(limbs: Limbs, s: jnp.ndarray) -> Limbs:
    """Variable logical right shift (same contract as shl_var)."""
    n = len(limbs)
    s = s.astype(U32)
    words = s >> U32(5)
    bits = s & U32(31)
    nz = bits != 0
    out = []
    for i in range(n):
        acc = jnp.zeros_like(limbs[0])
        for w in range(n):
            sel = words == U32(w)
            src = i + w
            v = jnp.zeros_like(limbs[0])
            if 0 <= src < n:
                v = limbs[src] >> bits
            if 0 <= src + 1 < n:
                carry = jnp.where(nz, limbs[src + 1] << (U32(32) - bits),
                                  jnp.zeros_like(limbs[0]))
                v = v | carry
            acc = jnp.where(sel, v, acc)
        out.append(acc)
    return tuple(out)


def bor(a: Limbs, b: Limbs) -> Limbs:
    return tuple(x | y for x, y in zip(a, b))


def band(a: Limbs, b: Limbs) -> Limbs:
    return tuple(x & y for x, y in zip(a, b))


def bnot(a: Limbs) -> Limbs:
    return tuple(~x for x in a)


def bxor(a: Limbs, b: Limbs) -> Limbs:
    return tuple(x ^ y for x, y in zip(a, b))


def add(a: Limbs, b: Limbs) -> Limbs:
    """Multi-limb add (mod 2^(32n)) with carry propagation."""
    out = []
    carry = None
    for x, y in zip(a, b):
        s = x + y
        if carry is not None:
            s2 = s + carry
            new_carry = ((s < x) | (s2 < s)).astype(U32)
            s = s2
        else:
            new_carry = (s < x).astype(U32)
        out.append(s)
        carry = new_carry
    return tuple(out)


def eq(a: Limbs, b: Limbs) -> jnp.ndarray:
    r = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        r = r & (x == y)
    return r


def lt(a: Limbs, b: Limbs) -> jnp.ndarray:
    """Lexicographic a < b from the most significant limb down."""
    n = len(a)
    r = a[0] < b[0]
    for i in range(1, n):
        r = jnp.where(a[i] == b[i], r, a[i] < b[i])
    return r


def le(a: Limbs, b: Limbs) -> jnp.ndarray:
    n = len(a)
    r = a[0] <= b[0]
    for i in range(1, n):
        r = jnp.where(a[i] == b[i], r, a[i] < b[i])
    return r


def select(pred: jnp.ndarray, a: Limbs, b: Limbs) -> Limbs:
    return tuple(jnp.where(pred, x, y) for x, y in zip(a, b))


def minimum(a: Limbs, b: Limbs) -> Limbs:
    return select(lt(a, b), a, b)


def stack(limbs: Limbs) -> jnp.ndarray:
    """Pack limbs into one array with a leading limb axis (for scan/IO)."""
    return jnp.stack(limbs, axis=0)


def unstack(arr: jnp.ndarray) -> Limbs:
    return tuple(arr[i] for i in range(arr.shape[0]))
