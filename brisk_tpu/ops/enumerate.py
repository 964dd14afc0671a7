"""Batched streaming super-k-mer enumerator.

Re-design of the reference SuperKmerEnumerator (Kmers.cpp:509-613): instead
of one sequential cursor per thread, a batch of B record lanes advances in
lock-step over L positions with jax.lax.scan. All heavy per-position math
(window values, candidate hashes, full get_minimizer rescans) is hoisted
OUT of the scan into the fused data-parallel pipeline; the scan step is a
handful of selects over (B,) vectors replicating the reference's control
flow literally:

    mini_pos += 1
    if mini_pos > k-m:        state = get_minimizer(kmer)      (expiry)
    elif cand_hash < hash:    state = rolling candidate        (new mini)
    emit k-mer in fwd or RC orientation per state.reversed

Streaming: records longer than one buffer continue across batches — the
host keeps the last k-1 bases as a margin and the minimizer state is
carried (MinimizerState per lane). Fresh lanes are initialized exactly like
the reference's seq_idx==0 path: get_minimizer over the (k-1)-mer ending at
position margin-1 (Kmers.cpp:526-534), with the first k-mer's super-k-mer
boundary suppressed (Kmers.cpp:590-592).

Layout contract for a (B, L_buf) codes buffer with margin = k-1:
  * fresh lane: record bases start at index 0; bases beyond the record are
    padding (any value).
  * continuing lane: indices [0, margin) hold the record's previous k-1
    bases, new bases start at margin.
  * valid_end[lane] = index one past the record's last base in this buffer.
  * emissions happen at positions p in [margin, L_buf); the emission at p
    is valid iff margin <= p < valid_end (fresh lanes' first k-1 positions
    never reach p >= margin with p < valid_end unless the record has >= k
    bases... records shorter than k must not be scheduled by the host).
"""

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from brisk_tpu.ops import codec, hashing, minimizer, u128
from brisk_tpu.ops.minimizer import MinimizerState

U32 = np.uint32  # numpy scalar: avoids device-constant embedding at trace time


class Emissions(NamedTuple):
    """Per-position emission records, arrays shaped (B, L_out)."""
    valid: jnp.ndarray     # bool: real k-mer emitted here
    boundary: jnp.ndarray  # bool: a super-k-mer ended just before this k-mer
    use_rc: jnp.ndarray    # bool: emitted in RC orientation
    mini_idx: jnp.ndarray  # u32: minimizer_idx (suffix length)
    mini_lo: jnp.ndarray   # u32: canonical minimizer value (2 limbs)
    mini_hi: jnp.ndarray
    hash_hi: jnp.ndarray   # u32: mixed 2m-bit minimizer hash (no heavy)
    hash_lo: jnp.ndarray
    kmer: jnp.ndarray      # (4, B, L_out) u32: emitted (oriented) k-mer
    key: jnp.ndarray       # (4, B, L_out) u32: hashed k-mer (slice replaced)
    bucket: jnp.ndarray    # u32: reduced-minimizer bucket id
    cert: jnp.ndarray      # (B,) bool: warm-up re-sync certificate (always
    #                        True outside windowed mode; see io.windows)
    replay: MinimizerState  # per-lane machine state at the END of the
    #                         warm-up replay (position valid_start-1),
    #                         (B,) leaves — compared against the previous
    #                         window's end state for the equality
    #                         certificate (windowed mode only; garbage for
    #                         lanes with valid_start == margin)


def zero_carry(batch: int) -> MinimizerState:
    z = jnp.zeros((batch,), dtype=U32)
    return MinimizerState(z, z, z, jnp.zeros((batch,), dtype=bool), z, z, z)


@partial(jax.jit, static_argnames=("k", "m", "b"))
def enumerate_batch(codes: jnp.ndarray, fresh: jnp.ndarray,
                    valid_end: jnp.ndarray, carry: MinimizerState,
                    k: int, m: int, b: int,
                    valid_start: jnp.ndarray = None
                    ) -> Tuple[Emissions, MinimizerState]:
    """codes: (B, L_buf) uint32 2-bit codes. Returns emissions for positions
    [margin, L_buf) and the next carry.

    valid_start ((B,) int32, optional): first buffer position whose
    emission is valid (defaults to margin). Used by the sequence-parallel
    window packer (io.windows) to mask the warm-up replay region of
    overlapping windows."""
    margin = k - 1
    B, L_buf = codes.shape
    L_out = L_buf - margin
    codes = codes.astype(U32)  # accept uint8 input (4x less H2D traffic)

    windowed = valid_start is not None
    # k > 32 windowed mode: the reference's truncation quirk (Kmers.cpp:371)
    # makes the rescan hash differ from the rolling window minimum, so the
    # unique-window-minimum certificate does not hold — those lanes rely
    # on the end-state EQUALITY certificate instead (em.replay compared to
    # the predecessor window's end state, chained in the pipeline).
    with_unique = windowed and k <= 32

    pa = minimizer.position_pipeline(codes, k, m)
    rescan_out = minimizer.windowed_get_minimizer(
        pa, pa.fwd_k, k, m, with_unique=with_unique)
    rescan, unique = rescan_out if with_unique else (rescan_out, None)

    # Init state for fresh lanes: get_minimizer over the (k-1)-mer ending at
    # margin-1 (computed on the margin-wide prefix only).
    pa_init = minimizer.position_pipeline(codes[:, :margin], k - 1, m)
    init_full = minimizer.windowed_get_minimizer(
        pa_init, pa_init.fwd_k, k - 1, m)
    init = MinimizerState(*(x[:, -1] for x in init_full))

    state0 = MinimizerState(
        *(jnp.where(fresh, i, c) for i, c in zip(init, carry)))

    # Chunked scan: C positions per lax.scan step with an unrolled inner
    # loop — the per-iteration overhead of a device while-loop would
    # otherwise dominate at one position per step (C to retune on the
    # H100, ROADMAP S7).
    # L_out is padded up to a multiple of C (the padded positions run the
    # state machine on garbage and are discarded; the carry is then
    # recovered from the last REAL position's outputs).
    C = 16
    L_pad = -(-L_out // C) * C
    n_steps = L_pad // C
    need_pad = L_pad != L_out

    def col(x):
        # (B, L_buf) -> (n_steps, C, B) over the emitting positions
        x = jnp.moveaxis(x[:, margin:], -1, 0)
        if need_pad:
            x = jnp.pad(x, ((0, L_pad - L_out), (0, 0)))
        return x.reshape(n_steps, C, -1)

    xs = dict(
        heavy=col(pa.cand_hash[0]), hhi=col(pa.cand_hash[1]),
        hlo=col(pa.cand_hash[2]),
        c_lo=col(pa.canon_m[0]), c_hi=col(pa.canon_m[1]),
        is_rc=col(pa.cand_is_rc),
        r_mini_lo=col(rescan.mini_lo), r_mini_hi=col(rescan.mini_hi),
        r_pos=col(rescan.pos), r_rev=col(rescan.rev),
        r_heavy=col(rescan.heavy), r_hhi=col(rescan.hash_hi),
        r_hlo=col(rescan.hash_lo),
        t=jnp.arange(L_pad, dtype=U32).reshape(n_steps, C),
    )

    km = U32(k - m)

    def one_position(state: MinimizerState, x):
        pos1 = state.pos + U32(1)
        expiry = pos1 > km
        cand_h = (x["heavy"], x["hhi"], x["hlo"])
        cur_h = (state.heavy, state.hash_hi, state.hash_lo)
        improve = (~expiry) & hashing.hash_lt(cand_h, cur_h)

        resc = MinimizerState(x["r_mini_lo"], x["r_mini_hi"], x["r_pos"],
                              x["r_rev"], x["r_heavy"], x["r_hhi"],
                              x["r_hlo"])
        roll = MinimizerState(x["c_lo"], x["c_hi"], jnp.zeros_like(pos1),
                              x["is_rc"], x["heavy"], x["hhi"], x["hlo"])
        kept = state._replace(pos=pos1)
        new = MinimizerState(*(
            jnp.where(expiry, r, jnp.where(improve, c, s))
            for r, c, s in zip(resc, roll, kept)))

        suppress = (x["t"] == U32(0)) & fresh
        boundary = (expiry | improve) & (~suppress)
        # pos/heavy always emitted: the padded-carry recovery needs them at
        # L_out-1 and the windowed equality certificate reads the full
        # state at the replay boundary (valid_start-1)
        out = dict(boundary=boundary, use_rc=new.rev,
                   mini_idx=jnp.where(new.rev, km - new.pos, new.pos),
                   mini_lo=new.mini_lo, mini_hi=new.mini_hi,
                   hash_hi=new.hash_hi, hash_lo=new.hash_lo,
                   pos=new.pos, heavy=new.heavy)
        return new, out

    def step(state: MinimizerState, xc):
        outs = []
        for c in range(C):
            x = {f: v[c] for f, v in xc.items()}
            state, out = one_position(state, x)
            outs.append(out)
        stacked = {f: jnp.stack([o[f] for o in outs])
                   for f in outs[0]}
        return state, stacked

    final_state, ys = jax.lax.scan(step, state0, xs)
    ys = {f: v.reshape(L_pad, -1)[:L_out] for f, v in ys.items()}
    if need_pad:
        final_state = MinimizerState(
            mini_lo=ys["mini_lo"][-1], mini_hi=ys["mini_hi"][-1],
            pos=ys["pos"][-1], rev=ys["use_rc"][-1],
            heavy=ys["heavy"][-1], hash_hi=ys["hash_hi"][-1],
            hash_lo=ys["hash_lo"][-1])

    def row(x):
        return jnp.moveaxis(x, 0, -1)  # (L_out, B) -> (B, L_out)

    pos_idx = jnp.arange(margin, L_buf, dtype=U32)[None, :]
    valid = pos_idx < valid_end[:, None]
    if windowed:
        valid = valid & (pos_idx >= valid_start[:, None].astype(U32))
        # Re-sync certificate: during the warm-up replay region
        # [margin, valid_start) both the warm machine and the sequential
        # machine hold hash == window-min (invariant: the fresh init
        # covers exactly the window prefix); a position with a UNIQUE
        # window minimum therefore forces full state agreement, and the
        # machines stay in lock-step afterwards. Lanes with
        # valid_start == margin (record starts / window 0) are exact by
        # construction. For k > 32 the unique-minimum argument fails
        # (truncation quirk) and only the window-0 rule certifies here;
        # the pipeline adds the end-state EQUALITY certificate on top
        # (em.replay vs predecessor end, pipeline._chain_exact).
        in_replay = pos_idx < valid_start[:, None].astype(U32)
        cert = valid_start == margin
        if unique is not None:
            cert = cert | jnp.any(unique[:, margin:] & in_replay, axis=1)
    else:
        cert = jnp.ones((B,), dtype=bool)

    use_rc = row(ys["use_rc"])
    mini_idx = row(ys["mini_idx"])
    hash_hi = row(ys["hash_hi"])
    hash_lo = row(ys["hash_lo"])

    fwd_k = tuple(l[:, margin:] for l in pa.fwd_k)
    rc_k = tuple(l[:, margin:] for l in pa.rc_k)
    kmer = u128.select(use_rc, rc_k, fwd_k)

    # The stored key replaces the minimizer slice of the emitted k-mer by
    # the hash of the ACTUAL slice (hash_kmer_minimizer_inplace extracts
    # from the k-mer, Kmers.cpp:191-200) — which can differ from the
    # tracked minimizer after a truncated rescan (k > 32) or the forced-
    # strand tie-break. Extract the slice from the emitted k-mer with a
    # variable shift and mix it (mixer only — the heavy class is masked out
    # of the written slice and cannot reach the bucket bits).
    slice_mm = u128.mask_bits(u128.shr_var(kmer, mini_idx * U32(2)), 2 * m)
    slice_hi, slice_lo = hashing.mix_key(slice_mm[0], slice_mm[1], m)

    key = _hash_slice_replace(kmer, mini_idx, slice_hi, slice_lo, m)
    bucket = _bucket_id(slice_hi, slice_lo, m, b)

    if windowed:
        # full machine state at the replay boundary (position
        # valid_start-1): compared against the predecessor window's end
        # state by the pipeline's equality certificate. One-hot masked
        # reduction, NOT take_along_axis (one fused compare-and-sum, no
        # gather).
        ridx = (valid_start - margin - 1).astype(jnp.int32)
        onehot = jnp.arange(L_out, dtype=jnp.int32)[None, :] == ridx[:, None]

        def take(a2d):
            return jnp.max(jnp.where(onehot, a2d, 0), axis=1)

        replay = MinimizerState(
            mini_lo=take(row(ys["mini_lo"])),
            mini_hi=take(row(ys["mini_hi"])),
            pos=take(row(ys["pos"])),
            rev=jnp.any(onehot & use_rc, axis=1),
            heavy=take(row(ys["heavy"])),
            hash_hi=take(hash_hi), hash_lo=take(hash_lo))
    else:
        replay = final_state

    em = Emissions(
        valid=valid, boundary=row(ys["boundary"]), use_rc=use_rc,
        mini_idx=mini_idx, mini_lo=row(ys["mini_lo"]),
        mini_hi=row(ys["mini_hi"]), hash_hi=hash_hi, hash_lo=hash_lo,
        kmer=u128.stack(kmer), key=u128.stack(key), bucket=bucket,
        cert=cert, replay=replay)
    return em, final_state


def _hash_slice_replace(kmer: u128.Limbs, mini_idx: jnp.ndarray,
                        hash_hi: jnp.ndarray, hash_lo: jnp.ndarray,
                        m: int) -> u128.Limbs:
    """Replace the minimizer slice inside the k-mer by the low 2m bits of
    its hash (reference hash_kmer_minimizer_inplace, Kmers.cpp:191-200)."""
    shift = mini_idx * U32(2)
    zeros = jnp.zeros_like(hash_lo)
    m_mask4 = u128.mask_bits((~zeros, ~zeros, ~zeros, ~zeros), 2 * m)
    hole = u128.bnot(u128.shl_var(m_mask4, shift))
    slice4 = u128.mask_bits((hash_lo, hash_hi, zeros, zeros), 2 * m)
    return u128.bor(u128.band(kmer, hole), u128.shl_var(slice4, shift))


def _bucket_id(hash_hi: jnp.ndarray, hash_lo: jnp.ndarray, m: int, b: int
               ) -> jnp.ndarray:
    """Reduced minimizer: drop (m_reduc+1)/2 suffix bases from the hashed
    minimizer, keep 2b bits (reference Brisk.hpp:135-137). b <= 15."""
    m_reduc = m - b
    suffix_reduc = (m_reduc + 1) // 2
    small = u128.shr(u128.mask_bits((hash_lo, hash_hi), 2 * m),
                     2 * suffix_reduc)
    return small[0] & U32((1 << (2 * b)) - 1)
