"""Decycling-set classification (reference Decycling.cpp:7-52) on device.

The reference computes R(seq) = sum over base slots of coef[4*i + v] in
float64 and compares against eps=1e-6 to classify each m-mer into
{0: decycling set, 1: double set, 2: other}; the class becomes the top two
bits of the minimizer hash (hashing.cpp:9,17) and therefore dominates the
minimizer order.

R is evaluated without float64 (the design was first built for a device
without it; ROADMAP D4), in compensated float32-pair
("double-float") arithmetic: each float64 table entry is split hi+lo into
two float32s and accumulated with TwoSum. The result carries ~2^-45
relative error vs the reference's float64 — classification can only
diverge if the true R lies within ~1e-13 of ±eps, which is validated
empirically against the float64 oracle (tests/test_ops.py runs
exhaustive small-m and sampled large-m comparisons).

Linear form used here: the reference's computeR consumes the m-mer from
its LAST base upward with coef index 4*(m-1) downward, which is exactly
    R(x)    = sum_{j=1}^{m-1} table[v_j * sin(2*pi*j/m)]
    R(rot)  = sum_{j=0}^{m-2} table[v_j * sin(2*pi*(j+1)/m)]
where v_j is the base value at slot j counted from the LEFT of the m-mer,
and table[] reproduces the C++ coef construction (v=2 entry computed as
2*s, v=3 entry as 3*s with its float64 rounding).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np

F32 = np.float32  # numpy scalar: avoids device-constant embedding at trace time


@functools.lru_cache(maxsize=None)
def contribution_tables(m: int):
    """Host precompute: (WR, WT) each float64 ndarray [m][4], entry =
    exact C++ coef value contributed by value v at slot j."""
    unit = 2 * math.pi / m
    coef = np.zeros(4 * m, dtype=np.float64)
    for i in range(4, 4 * m, 4):
        s = math.sin(unit * (i // 4))
        coef[i + 1] = s
        coef[i + 2] = 2 * s
        coef[i + 3] = 3 * s  # float64 rounding preserved
    WR = np.zeros((m, 4), dtype=np.float64)
    WT = np.zeros((m, 4), dtype=np.float64)
    for j in range(m):
        for v in range(4):
            if j >= 1:
                WR[j, v] = coef[4 * j + v]
            if j <= m - 2:
                WT[j, v] = coef[4 * (j + 1) + v]
    return WR, WT


def _split_df(x64: np.ndarray):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _df_add(hi, lo, bhi, blo):
    """(hi,lo) + (bhi,blo) in double-float."""
    s, e = _two_sum(hi, bhi)
    e = e + lo + blo
    new_hi = s + e
    new_lo = e - (new_hi - s)
    return new_hi, new_lo


_EPS = 1e-6
_EPS_HI = np.float32(_EPS)
_EPS_LO = np.float32(_EPS - np.float64(np.float32(_EPS)))


def mem_double(mmer_lo: jnp.ndarray, mmer_hi: jnp.ndarray, m: int
               ) -> jnp.ndarray:
    """Vectorized memDouble class of 2-limb m-mers. Returns uint32 in
    {0,1,2}."""
    WR, WT = contribution_tables(m)
    WRh, WRl = _split_df(WR)
    WTh, WTl = _split_df(WT)

    r_hi = jnp.zeros_like(mmer_lo, dtype=F32)
    r_lo = jnp.zeros_like(mmer_lo, dtype=F32)
    t_hi = jnp.zeros_like(mmer_lo, dtype=F32)
    t_lo = jnp.zeros_like(mmer_lo, dtype=F32)
    for j in range(m):
        # base value at slot j (from the left): bits 2*(m-1-j)
        bit = 2 * (m - 1 - j)
        if bit >= 32:
            v = (mmer_hi >> jnp.uint32(bit - 32)) & jnp.uint32(3)
        elif bit > 0:
            # slot may straddle the limb boundary only at bit 31 (odd bit
            # positions never occur: bit is even), so plain in-limb extract
            v = (mmer_lo >> jnp.uint32(bit)) & jnp.uint32(3)
        else:
            v = mmer_lo & jnp.uint32(3)

        def pick(tab_h, tab_l):
            ch = jnp.where(v == 1, F32(tab_h[j, 1]),
                           jnp.where(v == 2, F32(tab_h[j, 2]),
                                     jnp.where(v == 3, F32(tab_h[j, 3]),
                                               F32(0.0))))
            cl = jnp.where(v == 1, F32(tab_l[j, 1]),
                           jnp.where(v == 2, F32(tab_l[j, 2]),
                                     jnp.where(v == 3, F32(tab_l[j, 3]),
                                               F32(0.0))))
            return ch, cl

        if np.any(WR[j]):
            ch, cl = pick(WRh, WRl)
            r_hi, r_lo = _df_add(r_hi, r_lo, ch, cl)
        if np.any(WT[j]):
            ch, cl = pick(WTh, WTl)
            t_hi, t_lo = _df_add(t_hi, t_lo, ch, cl)

    def df_gt(hi, lo, chi, clo):
        # (hi,lo) > (chi,clo): compute the difference, test sign of hi part
        dh, dl = _df_add(hi, lo, -chi, -clo)
        return (dh + dl) > 0

    r_gt_eps = df_gt(r_hi, r_lo, _EPS_HI, _EPS_LO)
    r_lt_neg = df_gt(-r_hi, -r_lo, _EPS_HI, _EPS_LO)
    t_lt_eps = df_gt(_EPS_HI, _EPS_LO, t_hi, t_lo)
    t_gt_neg = df_gt(t_hi, t_lo, -_EPS_HI, -_EPS_LO)

    cls = jnp.full(mmer_lo.shape, 2, dtype=jnp.uint32)
    cls = jnp.where(r_gt_eps & t_lt_eps, jnp.uint32(0), cls)
    cls = jnp.where((~r_gt_eps) & r_lt_neg & t_gt_neg, jnp.uint32(1), cls)
    return cls
