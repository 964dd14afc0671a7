"""Compacted super-k-mer storage — the device-resident SKL (reference
SuperKmerLight.hpp:18-122, buckets.hpp:19-58, SURVEY §2 C8).

The reference's space thesis: store each super-k-mer ONCE as
(k-b) + size - 1 nucleotides (the b bucket bases are implicit in the
bucket id) plus per-k-mer DATA — ~6 bytes of record + shared arena bytes
per super-k-mer instead of a full k-mer per row. Here the same record
becomes fixed-width array columns:

    bucket: u32          reduced-minimizer bucket id (0xFFFFFFFF = dead)
    meta:   u32          size (kmers, bits 0-7) | mini_idx (bits 8-15)
    nucs:   (NW, ) u32   compacted super-k-mer value, 2 bits/base, the
                         LAST base in the low bits (str2num convention)

where mini_idx is the REDUCED suffix length (reference kmer_mini_idx =
kmer.minimizer_idx + (m_reduc+1)/2, SuperKmerLight.hpp:99) of the LAST
k-mer, and the nucleotides live in HASHED-minimizer space exactly like
the reference's storage (hash_kmer_minimizer_inplace before insertion,
Brisk.hpp:133): k-mer j of a row (j=0 leftmost) is recovered by windowing
2*(k-b) bits at offset 2*(size-1-j) and re-inserting the 2b bucket bits
at hole offset h_j = mini_idx - (size-1-j).

Rows are built ON DEVICE during enumeration (segment assembly over
emission batches, pipeline.insert_windows_skl) and appended to a
log-structured arena; `finalize` consolidates duplicate k-mer counts
across rows by EXPANDING rows to per-k-mer packed keys (transiently),
sorting, and writing run totals back in arena order — each duplicated
k-mer keeps its count on exactly one (the first) slot, later copies
becoming zero-count dead slots. Super-k-mers split at window/batch seams
appear as separate rows (the k-mer content and counts are identical; only
the grouping differs — the reference's enumerator, scanning sequentially,
would have joined them).

Resident cost after finalize ~= (8 + 4*NW)/avg_size + 4 bytes per k-mer
(~7 B at k=31,b=8 with typical ~6-12 k-mers/super-k-mer) vs 16 B/k-mer
for the packed per-k-mer store and 28 B in round 1.
"""

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from brisk_tpu.index import store
from brisk_tpu.ops import u128

U32 = np.uint32
_INVALID = U32(0xFFFFFFFF)


# Max k-mers per stored row. The enumerator's natural bound is
# 2*(k-m)+1 (41 at k=31 m=11, 85 at k=63 m=21) but the AVERAGE is ~6;
# rows are fixed-width, so a large s_max inflates both the nucleotide
# words per row (9 u32 at k=63!) and the finalize expansion/consolidate
# work (s_max/avg slots processed per real k-mer). Longer runs are SPLIT
# into several rows at build time (rows_from_emissions) — k-mer content
# and counts are unaffected, exactly like the window-seam splits the
# format already absorbs. 8 keeps nw at 2 words (k=31) / 4 words (k=63)
# and bounds slot waste at ~1.3x on typical data (50 Mb: 63M expanded
# slots for 50M k-mers vs 96M at cap 16, 330M uncapped) — the
# consolidate sort is the finalize wall, and it scales with slots.
# Power of two (the splitter masks).
SKL_SIZE_CAP = 8


def skl_dims(k: int, m: int, b: int) -> Tuple[int, int, int, int]:
    """(compacted_size, max kmers/skl, max nucleotides, nuc words)."""
    cs = k - b
    s_max = min(2 * (k - m) + 1, SKL_SIZE_CAP)
    nt_max = cs + s_max - 1
    return cs, s_max, nt_max, -(-(2 * nt_max) // 32)


class SklState(NamedTuple):
    bucket: jnp.ndarray   # (rcap,) u32
    meta: jnp.ndarray     # (rcap,) u32: size | mini_idx << 8
    nucs: jnp.ndarray     # (NW, rcap) u32
    data: jnp.ndarray     # (kcap,) u32 per-slot counts of FINALIZED rows
    offs: jnp.ndarray     # (rcap,) u32 data offset per finalized row
    n_rows: jnp.ndarray   # () i32: raw rows used (incl. dead/tombstones)
    n_fin_rows: jnp.ndarray   # () i32 rows covered by data/offs
    n_fin_kmers: jnp.ndarray  # () i32 slots covered by data


def empty(row_cap: int, kmer_cap: int, nw: int) -> SklState:
    return SklState(
        bucket=jnp.full((row_cap,), _INVALID, dtype=U32),
        meta=jnp.zeros((row_cap,), dtype=U32),
        nucs=jnp.zeros((nw, row_cap), dtype=U32),
        data=jnp.zeros((kmer_cap,), dtype=U32),
        offs=jnp.zeros((row_cap,), dtype=U32),
        n_rows=jnp.int32(0), n_fin_rows=jnp.int32(0),
        n_fin_kmers=jnp.int32(0))


def grow(state: SklState, row_cap: int, kmer_cap: int) -> SklState:
    rpad = row_cap - state.bucket.shape[0]
    kpad = kmer_cap - state.data.shape[0]
    assert rpad >= 0 and kpad >= 0
    return SklState(
        bucket=jnp.pad(state.bucket, (0, rpad),
                       constant_values=np.uint32(0xFFFFFFFF)),
        meta=jnp.pad(state.meta, (0, rpad)),
        nucs=jnp.pad(state.nucs, ((0, 0), (0, rpad))),
        data=jnp.pad(state.data, (0, kpad)),
        offs=jnp.pad(state.offs, (0, rpad)),
        n_rows=state.n_rows, n_fin_rows=state.n_fin_rows,
        n_fin_kmers=state.n_fin_kmers)


def ensure_room(state: SklState, n_rows_incoming: int) -> SklState:
    rcap = state.bucket.shape[0]
    target = rcap
    while int(state.n_rows) + n_rows_incoming > target:
        target *= 2
    if target != rcap:
        state = grow(state, target, state.data.shape[0])
    return state


@jax.jit
def append(state: SklState, bucket: jnp.ndarray, meta: jnp.ndarray,
           nucs: jnp.ndarray) -> SklState:
    """Append (N,) rows at the raw log tail. Dead rows carry
    bucket == INVALID (they occupy slots until the next finalize).
    Caller enforces capacity (ensure_room)."""
    n = bucket.shape[0]
    new_bucket = jax.lax.dynamic_update_slice(state.bucket, bucket,
                                              (state.n_rows,))
    new_meta = jax.lax.dynamic_update_slice(state.meta, meta,
                                            (state.n_rows,))
    new_nucs = jax.lax.dynamic_update_slice(state.nucs, nucs,
                                            (jnp.int32(0), state.n_rows))
    return state._replace(bucket=new_bucket, meta=new_meta, nucs=new_nucs,
                          n_rows=state.n_rows + n)


def append_n(state: SklState, bucket: jnp.ndarray, meta: jnp.ndarray,
             nucs: jnp.ndarray, n_live: jnp.ndarray) -> SklState:
    """DENSE append (device, called inside jit): write the full fixed-width
    block at the tail but advance n_rows by only the LIVE row count. The
    caller must pass the block live-rows-FIRST (dead INVALID rows sorted to
    the back), so the block's dead tail lands beyond the new n_rows and is
    overwritten by the next append — the arena stays dense (no tombstones),
    which is what kills the per-flush compress_rows sorts of round 2
    (VERDICT r2 item 1). Caller guarantees n_rows + block_width <= rcap."""
    new_bucket = jax.lax.dynamic_update_slice(state.bucket, bucket,
                                              (state.n_rows,))
    new_meta = jax.lax.dynamic_update_slice(state.meta, meta,
                                            (state.n_rows,))
    new_nucs = jax.lax.dynamic_update_slice(state.nucs, nucs,
                                            (jnp.int32(0), state.n_rows))
    return state._replace(bucket=new_bucket, meta=new_meta, nucs=new_nucs,
                          n_rows=state.n_rows + n_live)


# -- emission-batch -> skl rows (device, called inside insert pipelines) --

def _ones_mask_var(nbits: jnp.ndarray, n_limbs: int) -> u128.Limbs:
    """(1 << nbits) - 1 as limbs (variable nbits)."""
    ones = tuple(jnp.full(nbits.shape, 0xFFFFFFFF, dtype=U32)
                 for _ in range(n_limbs))
    return u128.bnot(u128.shl_var(ones, nbits))


def rows_from_emissions(key: jnp.ndarray, bucket: jnp.ndarray,
                        mini_idx: jnp.ndarray, use_rc: jnp.ndarray,
                        valid: jnp.ndarray, first_valid: jnp.ndarray,
                        boundary: jnp.ndarray, k: int, m: int, b: int,
                        row_cap: int):
    """Assemble compacted super-k-mer rows from one emission batch.

    key:       (4, B, L) hashed k-mer limbs (em.key)
    bucket, mini_idx: (B, L) u32; use_rc/valid/boundary: (B, L) bool
    first_valid: (B, L) bool — position is the lane's first valid emission
    row_cap:   max rows kept per lane (overflowing lanes are reported and
               contribute NO rows; callers re-run them at full width)

    Returns (row_bucket (B, row_cap) u32 with INVALID padding,
             row_meta (B, row_cap), row_nucs (NW, B, row_cap),
             overflow (B,) bool).

    All segment math is gather-free: positions of segment firsts/lasts
    come from monotone cummax/cummin over the lane, the variable-length
    nucleotide assembly is a SEGMENTED suffix-OR (associative_scan) over
    per-position disjoint bit contributions.
    """
    m_reduc = m - b
    suffix_reduc = (m_reduc + 1) // 2
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    B, L = bucket.shape
    key4 = u128.unstack(key)

    seg_start = valid & (boundary | first_valid)
    nxt = lambda x: jnp.pad(x[:, 1:], ((0, 0), (0, 1)))
    pos = jnp.broadcast_to(jnp.arange(L, dtype=U32)[None, :], (B, L))
    BIG = U32(0x7FFFFFFF)
    if 2 * (k - m) + 1 > s_max:
        # split runs longer than s_max into several rows (SKL_SIZE_CAP):
        # a position whose offset from its natural segment start is a
        # multiple of s_max starts a new row
        first0 = jax.lax.cummax(jnp.where(seg_start, pos, U32(0)), axis=1)
        j0 = jnp.where(valid, pos - first0, 0)
        seg_start = seg_start | (valid & ((j0 & U32(s_max - 1)) == 0))
    is_last = valid & (~nxt(valid) | nxt(seg_start))
    # nearest segment last at/after p; nearest start at/before p
    last_pos = jax.lax.cummin(jnp.where(is_last, pos, BIG), axis=1,
                              reverse=True)
    first_pos = jax.lax.cummax(jnp.where(seg_start, pos, U32(0)), axis=1)
    d = jnp.where(valid, last_pos - pos, 0)        # last - p
    j = jnp.where(valid, pos - first_pos, 0)       # p - first

    # hole offset of each kmer (reference kmer_mini_idx)
    h = mini_idx + U32(suffix_reduc)
    # compacted kmer: drop b bases at offset h
    hi_part = u128.shl_var(u128.shr_var(key4, U32(2) * (h + U32(b))),
                           U32(2) * h)
    lo_part = u128.band(key4, _ones_mask_var(U32(2) * h, 4))
    cmp4 = u128.bor(hi_part, lo_part)
    cmp4 = u128.mask_bits(cmp4, 2 * cs)

    zero = jnp.zeros((B, L), dtype=U32)
    cN = tuple(cmp4[i] if i < 4 else zero for i in range(nw))

    # disjoint per-position contributions to the segment value
    # fwd: j==0 -> full C << 2*(len-1) = 2*d ; j>0 -> (C & 3) << 2*d
    # rev: j==0 -> full C            ; j>0 -> firstbase(C) << 2*(cs-1+j)
    last_base = tuple((cN[0] & U32(3)) if i == 0 else zero
                      for i in range(nw))
    first_base_val = (cmp4[(2 * (cs - 1)) // 32] >>
                      U32((2 * (cs - 1)) % 32)) & U32(3)
    first_base = tuple(first_base_val if i == 0 else zero
                       for i in range(nw))

    fwd_contrib = u128.shl_var(
        u128.select(j == 0, cN, last_base), U32(2) * d)
    rev_contrib = u128.select(
        j == 0, cN,
        u128.shl_var(first_base, U32(2) * (U32(cs - 1) + j)))
    contrib = u128.select(use_rc, rev_contrib, fwd_contrib)
    contrib = tuple(jnp.where(valid, c, 0) for c in contrib)

    # Segmented suffix-OR: agg[p] = OR of contrib over [p, last of p's
    # segment]. Elements are functions f(x) = v | (r ? 0 : x) with
    # r = is_seg_last; composition is associative. NOTE on argument order:
    # with reverse=True, associative_scan feeds the LATER-index aggregate
    # as the FIRST argument (verified empirically), so the earlier
    # element is `bb` and its flag gates the absorption.
    def combine(a, bb):
        av, af = a
        bv, bf = bb
        v = tuple(y | jnp.where(bf, 0, x) for x, y in zip(av, bv))
        return v, af | bf

    agg, _ = jax.lax.associative_scan(
        combine, (contrib, is_last), reverse=True, axis=1)

    size = jnp.where(seg_start, d + U32(1), 0)
    mini_last = jnp.where(use_rc, h, h + d)  # max hole offset in segment
    meta = size | (mini_last << U32(8))

    # per-lane compression: segment starts to the front, in order
    n_seg = jnp.sum(seg_start, axis=1).astype(jnp.int32)
    overflow = n_seg > row_cap
    keep = seg_start & ~overflow[:, None]
    sort_key = jnp.where(keep, pos, BIG)
    row_bucket = jnp.where(keep, bucket, _INVALID)
    ops = (sort_key, row_bucket, meta) + tuple(agg)
    out = jax.lax.sort(ops, dimension=1, num_keys=1)
    row_bucket = out[1][:, :row_cap]
    row_meta = out[2][:, :row_cap]
    row_nucs = jnp.stack([o[:, :row_cap] for o in out[3:]])
    return row_bucket, row_meta, row_nucs, overflow


@jax.jit
def _compress(bucket, meta, nucs, n_fin_rows):
    """Stable-partition live rows to the front (fresh tombstones from the
    fixed-width appends go to the back). The finalized prefix contains no
    tombstones (finalize drops dead rows), so offs stay valid."""
    n = bucket.shape[0]
    tomb = bucket == _INVALID
    key = jnp.where(tomb, U32(0xFFFFFFFF), jnp.arange(n, dtype=U32))
    nw = nucs.shape[0]
    ops = (key, bucket, meta) + tuple(nucs[i] for i in range(nw))
    out = jax.lax.sort(ops, num_keys=1)
    n_live = jnp.sum(~tomb).astype(jnp.int32)
    return out[1], out[2], jnp.stack(out[3:]), n_live


def compress_rows(state: SklState) -> SklState:
    """Host wrapper: reclaim tombstone rows (pow2-prefix sort)."""
    n = int(state.n_rows)
    rcap = state.bucket.shape[0]
    n2 = min(rcap, 1 << max(10, (max(n, 1) - 1).bit_length()))
    bucket, meta, nucs, n_live = _compress(
        state.bucket[:n2], state.meta[:n2], state.nucs[:, :n2],
        state.n_fin_rows)
    new_bucket = jax.lax.dynamic_update_slice(state.bucket, bucket, (0,))
    new_meta = jax.lax.dynamic_update_slice(state.meta, meta, (0,))
    new_nucs = jax.lax.dynamic_update_slice(state.nucs, nucs,
                                            (jnp.int32(0), jnp.int32(0)))
    return state._replace(bucket=new_bucket, meta=new_meta, nucs=new_nucs,
                          n_rows=n_live)


def ensure_room_compressing(state: SklState, n_incoming: int) -> SklState:
    """compact-before-grow for the skl arena: reclaim tombstones first,
    grow only if live rows still don't fit."""
    rcap = state.bucket.shape[0]
    if int(state.n_rows) + n_incoming > rcap:
        state = compress_rows(state)
    return ensure_room(state, n_incoming)


# -- finalize: consolidate duplicate kmer counts, drop dead rows ---------

@partial(jax.jit, static_argnames=("k", "m", "b", "s_max"))
def _expand_chunk(bucket, meta, nucs, base_count,
                  k: int, m: int, b: int, s_max: int):
    """Expand (R,) rows into (R*s_max,) per-kmer packed keys + counts.

    base_count: (R, s_max) u32 counts per slot (callers gather from data
    for finalized rows; 1 for fresh rows). Returns (keys (W, R*s_max),
    cnt, valid) flattened in row-major slot order."""
    m_reduc = m - b
    suffix_reduc = (m_reduc + 1) // 2
    cs, _, _, nw = skl_dims(k, m, b)
    size = meta & U32(0xFF)
    mini = (meta >> U32(8)) & U32(0xFF)
    live = bucket != _INVALID
    zero = jnp.zeros_like(bucket)

    nucs_t = tuple(nucs[i] if i < nucs.shape[0] else zero
                   for i in range(max(nw, 4)))

    keys_all, cnt_all, val_all = [], [], []
    for jj in range(s_max):
        J = U32(jj)
        ok = live & (J < size)
        # kmer jj: window of 2*cs bits at offset 2*(size-1-jj)
        sh = U32(2) * jnp.where(ok, size - U32(1) - J, 0)
        shifted = u128.shr_var(nucs_t, sh)
        win = u128.mask_bits(tuple(shifted[:4]), 2 * cs)
        # re-insert the 2b bucket bits at hole offset h = mini-(size-1-jj)
        h = jnp.where(ok, mini - (size - U32(1) - J), 0)
        sh_h = U32(2) * h
        low = u128.band(win, _ones_mask_var(sh_h, 4))
        high = u128.shl_var(u128.shr_var(win, sh_h), sh_h + U32(2 * b))
        bucket4 = (bucket, zero, zero, zero)
        mid = u128.shl_var(bucket4, sh_h)
        kmer = u128.mask_bits(u128.bor(u128.bor(low, high), mid), 2 * k)
        full_mini_idx = jnp.where(ok, h - U32(suffix_reduc), 0)
        pk = store.make_keys(jnp.where(ok, bucket, _INVALID),
                             u128.stack(kmer), full_mini_idx, k, b)
        keys_all.append(pk)
        cnt_all.append(jnp.where(ok, base_count[:, jj], 0))
        val_all.append(ok)
    keys = jnp.stack(keys_all, axis=2).reshape(keys_all[0].shape[0], -1)
    cnt = jnp.stack(cnt_all, axis=1).reshape(-1)
    val = jnp.stack(val_all, axis=1).reshape(-1)
    return keys, cnt, val


def _expand_j_words(bucket, meta, nucs_t, J, k: int, m: int, b: int):
    """Big-endian packed-key WORD LIST (W arrays) + live mask for k-mer
    index J of each row; dead slots have every word == INVALID. Pure
    elementwise u32 math (variable shifts/masks only), run as a lax.scan
    step. Same math as _expand_chunk's unrolled loop; the block-scanned
    forms bound the per-J u128 intermediates to one row block, where the
    unrolled whole-span graph let XLA materialize all of them at once."""
    m_reduc = m - b
    suffix_reduc = (m_reduc + 1) // 2
    cs, _, _, nw = skl_dims(k, m, b)
    size = meta & U32(0xFF)
    mini = (meta >> U32(8)) & U32(0xFF)
    live = bucket != _INVALID
    zero = jnp.zeros_like(bucket)
    ok = live & (J < size)
    sh = U32(2) * jnp.where(ok, size - U32(1) - J, 0)
    shifted = u128.shr_var(nucs_t, sh)
    win = u128.mask_bits(tuple(shifted[:4]), 2 * cs)
    h = jnp.where(ok, mini - (size - U32(1) - J), 0)
    sh_h = U32(2) * h
    low = u128.band(win, _ones_mask_var(sh_h, 4))
    high = u128.shl_var(u128.shr_var(win, sh_h), sh_h + U32(2 * b))
    bucket4 = (bucket, zero, zero, zero)
    mid = u128.shl_var(bucket4, sh_h)
    kmer = u128.mask_bits(u128.bor(u128.bor(low, high), mid), 2 * k)
    full_mini_idx = jnp.where(ok, h - U32(suffix_reduc), 0)
    words = store.make_key_words(jnp.where(ok, bucket, _INVALID),
                                 kmer, full_mini_idx, k, b)
    return [jnp.where(ok, w, _INVALID) for w in words], ok


def _expand_one_j(bucket, meta, nucs_t, J, k: int, m: int, b: int):
    """Packed keys (W, R) + live mask (R,) for k-mer index J (a TRACED
    u32 scalar — this runs as a lax.scan body) of each row."""
    words, ok = _expand_j_words(bucket, meta, nucs_t, J, k, m, b)
    return jnp.stack(words), ok


def _nucs_tuple(bucket, nucs):
    zero = jnp.zeros_like(bucket)
    nw = nucs.shape[0]
    return tuple(nucs[i] if i < nw else zero for i in range(max(nw, 4)))


def expand_keys(state: SklState, k: int, m: int, b: int,
                chunk_rows: int = 1 << 18):
    """Expand the whole arena to per-kmer packed keys host-orchestrated in
    row chunks. Returns numpy (W, n_slots), counts (n_slots,), and the
    per-slot (row, j) ids — row-major over LIVE rows only."""
    cs, s_max, _, nw = skl_dims(k, m, b)
    n = int(state.n_rows)
    W = store.key_words(k, b)
    out_k, out_c, out_slot = [], [], []
    bucket_np = np.asarray(state.bucket)[:n]
    meta_np = np.asarray(state.meta)[:n]
    nucs_np = np.asarray(state.nucs)[:, :n]
    data_np = np.asarray(state.data)
    offs_np = np.asarray(state.offs)[:n]
    n_fin = int(state.n_fin_rows)
    for start in range(0, n, chunk_rows):
        end = min(start + chunk_rows, n)
        R = end - start
        sizes = meta_np[start:end] & 0xFF
        base_count = np.ones((R, s_max), dtype=np.uint32)
        fin = np.arange(start, end) < n_fin
        if fin.any():
            # gather finalized counts (vectorized)
            o = offs_np[start:end].astype(np.int64)
            idx = o[:, None] + np.arange(s_max)[None, :]
            idx = np.clip(idx, 0, len(data_np) - 1)
            cf = data_np[idx]
            base_count = np.where(fin[:, None], cf, base_count
                                  ).astype(np.uint32)
        keys, cnt, val = _expand_chunk(
            jnp.asarray(bucket_np[start:end]),
            jnp.asarray(meta_np[start:end]),
            jnp.asarray(nucs_np[:, start:end]),
            jnp.asarray(base_count), k=k, m=m, b=b, s_max=s_max)
        keys = np.asarray(keys)
        cnt = np.asarray(cnt)
        val = np.asarray(val)
        jslots = np.tile(np.arange(s_max, dtype=np.int64), R)
        rows = np.repeat(np.arange(start, end, dtype=np.int64), s_max)
        keep = val
        out_k.append(keys[:, keep])
        out_c.append(cnt[keep])
        out_slot.append(rows[keep] * s_max + jslots[keep])
    if not out_k:
        return (np.zeros((W, 0), np.uint32), np.zeros(0, np.uint32),
                np.zeros(0, np.int64))
    return (np.concatenate(out_k, axis=1), np.concatenate(out_c),
            np.concatenate(out_slot))


def finalize(state: SklState, k: int, m: int, b: int) -> SklState:
    """Consolidate duplicate k-mer counts, drop dead rows, group rows by
    bucket. Delegates to the device-resident pipeline (finalize_device);
    finalize_host below is the reference implementation kept for
    cross-checking in tests."""
    return finalize_device(state, k, m, b)


def finalize_host(state: SklState, k: int, m: int, b: int,
                  bucket_sort: bool = True) -> SklState:
    """Consolidate duplicate k-mer counts across rows and drop dead rows.

    Per duplicated k-mer the total lands on ONE slot (the first in
    pre-finalize arena order); later copies become zero-count slots; rows
    whose every slot is zero are dropped. Surviving rows are re-ordered
    GROUPED BY BUCKET (stable within a bucket) so lookups can slice a
    bucket's rows contiguously — the arena becomes the index's backing
    store, mirroring the reference's per-bucket SKL vectors
    (buckets.hpp:19-58). Produces a fully-finalized state (n_fin == n).

    Fully vectorized: the consolidation is one device sort over all
    expanded slots; the rebuild is numpy bincount/cumsum/fancy-index (no
    per-entry Python, VERDICT r2 weak #4)."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    keys, cnt, slot = expand_keys(state, k, m, b)
    n_slots = keys.shape[1]
    if n_slots == 0:
        return empty(state.bucket.shape[0], state.data.shape[0], nw)

    # sort by key (carry slot), totals at run firsts
    W = keys.shape[0]
    slot_lo = (slot & 0xFFFFFFFF).astype(np.uint32)
    slot_hi = (slot >> 32).astype(np.uint32)
    ops = tuple(jnp.asarray(keys[i]) for i in range(W)) + (
        jnp.asarray(slot_hi), jnp.asarray(slot_lo), jnp.asarray(cnt))
    out = jax.lax.sort(ops, num_keys=W + 2)  # ties broken by slot order
    skeys = out[:W]
    s_hi, s_lo, scnt = out[W], out[W + 1], out[W + 2]
    first = jnp.zeros(n_slots, dtype=bool).at[0].set(True)
    neq = jnp.zeros(n_slots, dtype=bool)
    for i in range(W):
        neq = neq | (skeys[i] != jnp.roll(skeys[i], 1))
    first = first | neq
    csum = jnp.cumsum(scnt, dtype=jnp.uint32)
    is_last = jnp.roll(first, -1).at[-1].set(True)
    last_csum = jax.lax.cummin(
        jnp.where(is_last, csum, U32(0xFFFFFFFF)), reverse=True)
    totals = jnp.where(first, last_csum - (csum - scnt), 0)
    # back to arena order
    back = jax.lax.sort((s_hi, s_lo, totals), num_keys=2)
    arena_counts = np.asarray(back[2])

    # rebuild arena: surviving rows + data + offs (host, vectorized)
    n = int(state.n_rows)
    bucket_np = np.asarray(state.bucket)[:n]
    meta_np = np.asarray(state.meta)[:n]
    nucs_np = np.asarray(state.nucs)[:, :n]
    sizes = (meta_np & 0xFF).astype(np.int64)
    live_row = bucket_np != 0xFFFFFFFF
    sizes = np.where(live_row, sizes, 0)
    # expand_keys emits slots in strictly increasing (arena) order and the
    # device sort-back restores exactly that order
    row_of_slot = slot // s_max
    # rows with any nonzero count survive
    any_live = np.bincount(row_of_slot[arena_counts > 0],
                           minlength=n).astype(bool)
    keep = live_row & any_live
    kept_rows = np.nonzero(keep)[0]
    if bucket_sort:  # group rows by bucket (stable in arena order)
        kept_rows = kept_rows[np.argsort(bucket_np[kept_rows],
                                         kind="stable")]
    new_sizes = sizes[kept_rows]
    new_offs = np.zeros(len(kept_rows), dtype=np.uint32)
    if len(kept_rows):
        new_offs[1:] = np.cumsum(new_sizes)[:-1].astype(np.uint32)
    total_k = int(new_sizes.sum())
    # per-slot gather: each kept row's live-slot run from the compact
    # arena_counts array (old start = cumsum of live sizes in OLD order)
    old_starts = np.zeros(n, dtype=np.int64)
    old_starts[1:] = np.cumsum(sizes)[:-1]
    rr = np.repeat(np.arange(len(kept_rows)), new_sizes)
    idx = (np.arange(total_k, dtype=np.int64)
           - np.repeat(new_offs.astype(np.int64), new_sizes)
           + np.repeat(old_starts[kept_rows], new_sizes))
    new_data = arena_counts[idx].astype(np.uint32)
    del rr

    rcap = state.bucket.shape[0]
    kcap = state.data.shape[0]
    while kcap < max(total_k, 1):
        kcap *= 2
    nr = len(kept_rows)
    out_bucket = np.full(rcap, 0xFFFFFFFF, dtype=np.uint32)
    out_meta = np.zeros(rcap, dtype=np.uint32)
    out_nucs = np.zeros((nucs_np.shape[0], rcap), dtype=np.uint32)
    out_offs = np.zeros(rcap, dtype=np.uint32)
    out_bucket[:nr] = bucket_np[kept_rows]
    out_meta[:nr] = meta_np[kept_rows]
    out_nucs[:, :nr] = nucs_np[:, kept_rows]
    out_offs[:nr] = new_offs
    out_data = np.zeros(kcap, dtype=np.uint32)
    out_data[:total_k] = new_data
    return SklState(
        bucket=jnp.asarray(out_bucket), meta=jnp.asarray(out_meta),
        nucs=jnp.asarray(out_nucs), data=jnp.asarray(out_data),
        offs=jnp.asarray(out_offs), n_rows=jnp.int32(nr),
        n_fin_rows=jnp.int32(nr), n_fin_kmers=jnp.int32(total_k))


# -- device-resident finalize (v3, round 5) ----------------------------
#
# The host-orchestrated finalize above moves the whole expansion through
# host memory (kept as the algorithmic oracle); the device pipeline
# below keeps every per-slot array in HBM. Round-5 redesign ("finalize
# v3"):
#
#   * PADDED data layout: finalized row r's counts live at data[offs[r]
#     + j] with offs[r] = r * s_max — slot positions are pure functions
#     of the row index, which removes every offs gather AND every
#     order-restoring sort from the expanders (consumers always went
#     through the offs column, so probes/KFF/joins are unchanged).
#   * SPAN finalize: ONE fused program consolidates rows [f, n) as a
#     bucket-grouped SEGMENT without touching the prefix — O(span)
#     work and memory, so huge inputs finalize incrementally
#     (mid-ingest, overlapped with transfers) instead of expanding the
#     whole arena at once (a span never needs more than its own slots'
#     sort operands).
#   * CHUNKED consolidation: the key sort + tag back-sort run as
#     BATCHED (C, CW) sorts — ~2x the comparator throughput of one
#     global sort (log^2 scaling). Duplicate keys split across chunk
#     (or segment) boundaries keep PARTIAL counts on multiple slots;
#     every consumer SUMS counts per key (probe, probe_np, joins,
#     readout), so totals stay exact. The exact DISTINCT count is
#     computed on demand by distinct_count() (a global key sort off the
#     hot path).
#   * consolidate_all(): the maintenance op (reference insert_buffer
#     merge analog, buckets.hpp:166-189) — re-consolidates the WHOLE
#     arena into one segment, merges cross-segment duplicates onto one
#     slot, and DROPS dead rows (all slots zero), bounding probe cost
#     over long insert/finalize cycles.


def _shape_family(n: int, floor: int = 1 << 12) -> int:
    """Smallest of {2^p, 3*2^(p-1)} >= n: bounds the number of distinct
    compiled shapes like pow2 sizing but wastes <= 33% instead of <= 100%
    (a pure pow2 S2 inflated the 50 Mb consolidate sort by 39%)."""
    n = max(n, floor)
    p2 = 1 << (n - 1).bit_length()
    if (3 * p2) // 4 >= n:
        return (3 * p2) // 4
    return p2


def _chunk_width(S2: int, cap: int = 1 << 18) -> int:
    """Largest power-of-two chunk width <= cap that divides S2 (S2 is
    family-shaped = 2^q or 3*2^(q-1), so the largest 2-power divisor is
    S2 & -S2)."""
    return min(cap, S2 & -S2, S2)


def _consolidate_chunked(keys, tag_template, cnt, S2: int,
                         cw_cap: int = 1 << 18):
    """Chunked consolidation: per-chunk key sort, run totals, back-sort
    by position tag. keys (W, S2); cnt (S2,) per-slot counts (0 on dead
    slots) or None (fresh span: every live slot counts 1, derived from
    key != INVALID — drops one sort operand). Returns (S2,) totals in
    the ORIGINAL slot order (dead slots 0).

    cw_cap bounds the chunk width: a comparison sort's cost per slot
    grows ~log^2(CW), while merge QUALITY (duplicates in one chunk land
    adjacent and consolidate onto one slot) only needs CW to cover a
    bucket group. Duplicates split across chunks keep split counts —
    exact under the readers' sum semantics; only dead-row dropping
    (consolidate_all) wants maximal merging."""
    W = keys.shape[0]
    CW = _chunk_width(S2, cw_cap)
    C = S2 // CW
    k2 = tuple(keys[i].reshape(C, CW) for i in range(W))
    tag = jnp.broadcast_to(jnp.arange(CW, dtype=U32)[None, :], (C, CW))
    ops = k2 + ((tag,) if cnt is None else (tag, cnt.reshape(C, CW)))
    out = jax.lax.sort(ops, dimension=1, num_keys=W)
    s_tag = out[W]
    if cnt is None:
        dead = out[0] == _INVALID
        for i in range(1, W):
            dead = dead & (out[i] == _INVALID)
        s_cnt = jnp.where(dead, U32(0), U32(1))
    else:
        s_cnt = out[W + 1]
    first = jnp.zeros((C, CW), dtype=bool).at[:, 0].set(True)
    neq = jnp.zeros((C, CW), dtype=bool)
    for i in range(W):
        neq = neq | (out[i] != jnp.roll(out[i], 1, axis=1))
    first = first | neq
    csum = jnp.cumsum(s_cnt, axis=1, dtype=jnp.uint32)
    is_last = jnp.roll(first, -1, axis=1).at[:, -1].set(True)
    last_csum = jax.lax.cummin(
        jnp.where(is_last, csum, U32(0xFFFFFFFF)), axis=1, reverse=True)
    totals = jnp.where(first, last_csum - (csum - s_cnt), 0)
    back = jax.lax.sort((s_tag, totals), dimension=1, num_keys=1)
    return back[1].reshape(S2)


def _row_block(R: int, target: int = 1 << 17) -> int:
    """Rows per block for the block-scan expanders: the largest
    power-of-two <= target dividing R (R is family-shaped, so R & -R is
    its largest 2-power divisor)."""
    return min(target, R & -R, R)


def _expand_span(sb, sm, sn, k: int, m: int, b: int, s_max: int):
    """Expand sorted span rows to ROW-MAJOR per-slot packed keys.

    The interleave runs as a lax.scan over ROW BLOCKS with the J loop
    unrolled INSIDE each step: the (RB, s_max) intermediate exists only
    at block scale, and the stacked ys output is naturally row-major
    (blocks are row-contiguous). This is the reference for the J-major
    expander and the expansion of the carry path (consolidate_all).
    Returns (keys (W, R*s_max), ok (R*s_max,)) with slot r*s_max + j."""
    R = sb.shape[0]
    W = store.key_words(k, b)
    nw = sn.shape[0]
    RB = _row_block(R)
    n_steps = R // RB
    xb = sb.reshape(n_steps, RB)
    xm = sm.reshape(n_steps, RB)
    xn = jnp.moveaxis(sn.reshape(nw, n_steps, RB), 1, 0)

    def step(_, x):
        sb_b, sm_b, sn_b = x
        nucs_t = _nucs_tuple(sb_b, sn_b)
        cols_k, cols_ok = [], []
        for J in range(s_max):
            keys, ok = _expand_one_j(sb_b, sm_b, nucs_t, U32(J), k, m, b)
            cols_k.append(jnp.where(ok[None, :], keys, _INVALID))
            cols_ok.append(ok)
        keys_b = jnp.stack(cols_k, axis=-1).reshape(W, RB * s_max)
        ok_b = jnp.stack(cols_ok, axis=-1).reshape(RB * s_max)
        return None, (keys_b, ok_b)

    _, (yk, yok) = jax.lax.scan(step, None, (xb, xm, xn))
    keys = jnp.moveaxis(yk, 0, 1).reshape(W, R * s_max)
    ok = yok.reshape(R * s_max)
    return keys, ok


def _expand_span_jmajor(sb, sm, sn, k: int, m: int, b: int, s_max: int):
    """Expand sorted span rows to J-MAJOR per-slot packed keys: keys
    (W, R*s_max) with slot j*R + r, so each J's key plane is contiguous
    and no per-row interleave is needed (the fresh-path consolidation is
    slot-order-agnostic under sum semantics). Dead slots (J >= size or
    dead row) have every word INVALID. Block-scanned like _expand_span:
    each step emits a (W, s_max, RB) stack, which reassembles into
    J-major slot order by a plain transpose of the step axis."""
    R = sb.shape[0]
    nw = sn.shape[0]
    RB = _row_block(R)
    n_steps = R // RB
    xb = sb.reshape(n_steps, RB)
    xm = sm.reshape(n_steps, RB)
    xn = jnp.moveaxis(sn.reshape(nw, n_steps, RB), 1, 0)

    def step(_, x):
        sb_b, sm_b, sn_b = x
        nucs_t = _nucs_tuple(sb_b, sn_b)
        planes = []
        for J in range(s_max):
            words, _ = _expand_j_words(sb_b, sm_b, nucs_t, U32(J), k, m, b)
            planes.append(jnp.stack(words))
        return None, jnp.stack(planes, axis=1)  # (W, s_max, RB)

    _, y = jax.lax.scan(step, None, (xb, xm, xn))
    # (n_steps, W, s_max, RB) -> slot j*R + step*RB + r
    return jnp.moveaxis(y, 0, 2).reshape(-1, s_max * R)


def _interleave_cols(cols, R: int, s_max: int):
    """s_max column arrays (R,) -> (R*s_max,) row-major, block-scanned
    (see _expand_span's layout note)."""
    RB = _row_block(R)
    n_steps = R // RB
    xs = tuple(c.reshape(n_steps, RB) for c in cols)

    def step(_, x):
        return None, jnp.stack(x, axis=-1).reshape(RB * s_max)

    _, y = jax.lax.scan(step, None, xs)
    return y.reshape(R * s_max)


@partial(jax.jit,
         static_argnames=("k", "m", "b", "s_max", "R_pad",
                          "carry_counts", "drop_dead"),
         donate_argnums=(0, 1, 2, 3, 4))
def _finalize_span_fused(bucket, meta, nucs, data, offs, f, n_rows,
                         k: int, m: int, b: int, s_max: int, R_pad: int,
                         carry_counts: bool, drop_dead: bool):
    """ONE device program finalizing rows [f, n_rows) (span width R_pad
    >= n_rows - f): bucket-group the span's rows, expand to per-slot
    packed keys, consolidate duplicate counts (chunked), write padded
    counts + rows + offs back into the donated arena at [f, f+R_pad).

    carry_counts: span rows may already be finalized — their padded
    count columns ride the row sort and feed the consolidation (the
    consolidate_all path); False = all span rows fresh (count 1/slot,
    one less sort operand). drop_dead (requires carry_counts): after
    consolidation, rows whose every slot total is zero are dropped
    (stable partition; the reference's merge drops nothing, but its
    insert-time dedup never creates dead entries — ours do, one per
    consolidated duplicate row).

    Returns (bucket', meta', nucs', data', offs', n_live_rows,
    total_k_span)."""
    W = store.key_words(k, b)
    nw = nucs.shape[0]
    S2 = R_pad * s_max
    iota = jnp.arange(R_pad, dtype=U32)
    z = jnp.int32(0)
    span_n = (n_rows - f).astype(jnp.int32)
    b_t = jax.lax.dynamic_slice(bucket, (f,), (R_pad,))
    m_t = jax.lax.dynamic_slice(meta, (f,), (R_pad,))
    n_t = jax.lax.dynamic_slice(nucs, (z, f), (nw, R_pad))
    in_span = iota < span_n.astype(U32)
    b_t = jnp.where(in_span, b_t, _INVALID)

    cnt_ops = ()
    if carry_counts:
        d_t = jax.lax.dynamic_slice(data, (f * s_max,), (S2,))
        cnt_ops = tuple(d_t[j::s_max] for j in range(s_max))
    # 1) bucket-group the span rows (stable in span order)
    ops = (b_t, iota, m_t) + tuple(n_t[i] for i in range(nw)) + cnt_ops
    srt = jax.lax.sort(ops, num_keys=2)
    sb, s_orig, sm = srt[0], srt[1], srt[2]
    sn = jnp.stack(srt[3:3 + nw])
    n_live = jnp.sum(sb != _INVALID).astype(jnp.int32)

    # 2+3) expand to per-slot keys and consolidate (chunked batched
    # sorts). The FRESH path runs J-MAJOR: the expansion emits
    # contiguous key planes (no per-row interleave of the keys), the
    # consolidation is slot-order-agnostic (within-span duplicates that
    # straddle chunks keep split counts under sum semantics either way),
    # and only the final totals pay ONE interleave back to the row-major
    # data layout. The carry path (consolidate_all) stays row-major:
    # its merge quality — which decides dead-row dropping — relies on
    # all 8 slots of neighboring rows landing in one chunk.
    if carry_counts:
        keys, ok = _expand_span(sb, sm, sn, k, m, b, s_max)
        scnt = _interleave_cols(srt[3 + nw:], R_pad, s_max)
        scnt = jnp.where(ok, scnt, 0)
        totals = _consolidate_chunked(keys, None, scnt, S2)
    else:
        keys_jm = _expand_span_jmajor(sb, sm, sn, k, m, b, s_max)
        # fresh spans: small chunks (cheaper sort); within-span merge
        # quality is structurally irrelevant here (no dead-row drop).
        # cw_cap was tuned on the earlier 16 GB device; to retune on the
        # H100 (ROADMAP S6)
        totals_jm = _consolidate_chunked(keys_jm, None, None, S2,
                                         cw_cap=1 << 12)
        tj = totals_jm.reshape(s_max, R_pad)
        totals = _interleave_cols(tuple(tj[j] for j in range(s_max)),
                                  R_pad, s_max)

    # 4) optional dead-row drop (stable live-first partition; padded
    # layout makes the per-row slot view a pure reshape)
    if drop_dead:
        tcols = tuple(totals[j::s_max] for j in range(s_max))
        row_alive = sb != _INVALID
        any_cnt = jnp.zeros_like(sb, dtype=bool)
        for j in range(s_max):
            any_cnt = any_cnt | (tcols[j] > 0)
        row_alive = row_alive & any_cnt
        part_key = jnp.where(row_alive, iota, _INVALID)
        ops2 = (part_key, sb, sm) + tuple(sn[i] for i in range(nw)) \
            + tcols
        out2 = jax.lax.sort(ops2, num_keys=1)
        alive_s = out2[0] != _INVALID
        sb = jnp.where(alive_s, out2[1], _INVALID)
        sm = out2[2]
        sn = jnp.stack(out2[3:3 + nw])
        totals = _interleave_cols(
            tuple(jnp.where(alive_s, c, 0) for c in out2[3 + nw:]),
            R_pad, s_max)
        n_live = jnp.sum(alive_s).astype(jnp.int32)

    # 5) sizes / offs / write-back
    sizes = jnp.where(sb != _INVALID, sm & U32(0xFF), 0)
    total_k = jnp.sum(sizes, dtype=jnp.uint32).astype(jnp.int32)
    offs_new = (f.astype(U32) + iota) * U32(s_max)
    bucket = jax.lax.dynamic_update_slice(bucket, sb, (f,))
    meta = jax.lax.dynamic_update_slice(meta, sm, (f,))
    nucs = jax.lax.dynamic_update_slice(nucs, sn, (z, f))
    offs = jax.lax.dynamic_update_slice(offs, offs_new, (f,))
    data = jax.lax.dynamic_update_slice(data, totals, (f * s_max,))
    return bucket, meta, nucs, data, offs, n_live, total_k


def _ensure_span_caps(state: SklState, f: int, R_pad: int, s_max: int
                      ) -> SklState:
    """Grow the arena so rows [f, f+R_pad) and data slots
    [f*s_max, (f+R_pad)*s_max) exist, in family-shaped capacities."""
    need_r = f + R_pad
    need_d = need_r * s_max
    rcap = state.bucket.shape[0]
    dcap = state.data.shape[0]
    new_r = rcap
    while new_r < need_r:
        new_r *= 2
    new_d = dcap if dcap >= need_d else _shape_family(need_d)
    if new_r != rcap or new_d != dcap:
        state = grow(state, new_r, new_d)
    return state


def finalize_span_dispatch(state: SklState, F: int, span_ub: int,
                           k: int, m: int, b: int):
    """DISPATCH the span finalize of rows [F, n_rows) without any host
    round-trip: the program reads the DEVICE n_rows scalar and the span
    width comes from a host UPPER BOUND (span_ub >= n_rows), so the call
    queues straight behind in-flight insert flushes — the caller's
    retire/repair bookkeeping then overlaps with its execution. Returns
    (state-with-new-arrays, n_live_dev, total_k_dev) — n_rows/n_fin are
    NOT yet updated (fold them after reading the scalars) — or None when
    span_ub <= F."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    if span_ub <= F:
        return None
    R_pad = _shape_family(span_ub - F, floor=1 << 10)
    assert (F + R_pad) * s_max < (1 << 32) - 1, "tag32/offs overflow"
    state = _ensure_span_caps(state, F, R_pad, s_max)
    bucket, meta, nucs, data, offs, n_live, total_k = \
        _finalize_span_fused(state.bucket, state.meta, state.nucs,
                             state.data, state.offs,
                             jnp.int32(F), state.n_rows,
                             k=k, m=m, b=b, s_max=s_max, R_pad=R_pad,
                             carry_counts=False, drop_dead=False)
    return (state._replace(bucket=bucket, meta=meta, nucs=nucs,
                           data=data, offs=offs),
            n_live, total_k)


def finalize_device(state: SklState, k: int, m: int, b: int) -> SklState:
    """Span finalize of the fresh tail [F, N): consolidates the tail
    into a new bucket-grouped segment (ONE fused device program; the
    prefix is untouched — its data stays position-aligned). Counts of
    k-mers duplicated ACROSS segments stay split (sum semantics);
    consolidate_all() merges them and drops dead rows."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    F, N = int(state.n_fin_rows), int(state.n_rows)
    if N == 0:
        return empty(state.bucket.shape[0], state.data.shape[0], nw)
    if N == F:
        return state  # fully finalized already (idempotent)
    disp = finalize_span_dispatch(state, F, N, k, m, b)
    state, n_live, total_k = disp
    nl, tk = jax.device_get((n_live, total_k))
    return state._replace(n_rows=jnp.int32(F + int(nl)),
                          n_fin_rows=jnp.int32(F + int(nl)),
                          n_fin_kmers=state.n_fin_kmers
                          + jnp.int32(int(tk)))


def consolidate_all(state: SklState, k: int, m: int, b: int) -> SklState:
    """Whole-arena maintenance (reference buckets.hpp:166-189 merge
    analog): re-consolidates EVERY row into one bucket-grouped segment,
    merges cross-segment duplicate counts onto one slot, drops dead
    rows. O(N) memory — for arenas too large for one pass, keep
    segment-local finalizes and accept split counts (sum semantics)."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    F, N = int(state.n_fin_rows), int(state.n_rows)
    if N == 0:
        return empty(state.bucket.shape[0], state.data.shape[0], nw)
    if F != N:
        state = finalize_device(state, k, m, b)
        N = int(state.n_rows)
    R_pad = _shape_family(N, floor=1 << 10)
    state = _ensure_span_caps(state, 0, R_pad, s_max)
    bucket, meta, nucs, data, offs, n_live, total_k = \
        _finalize_span_fused(state.bucket, state.meta, state.nucs,
                             state.data, state.offs,
                             jnp.int32(0), jnp.int32(N),
                             k=k, m=m, b=b, s_max=s_max, R_pad=R_pad,
                             carry_counts=True, drop_dead=True)
    nl, tk = jax.device_get((n_live, total_k))
    return SklState(bucket=bucket, meta=meta, nucs=nucs, data=data,
                    offs=offs, n_rows=jnp.int32(int(nl)),
                    n_fin_rows=jnp.int32(int(nl)),
                    n_fin_kmers=jnp.int32(int(tk)))


@partial(jax.jit, static_argnames=("k", "m", "b", "s_max", "R_pad"))
def _expand_all_padded(bucket_c, meta_c, nucs_c, data_c,
                       k: int, m: int, b: int, s_max: int, R_pad: int):
    """(keys (W, S2) row-major, counts (S2,)) of a FINALIZED arena
    prefix — counts are POSITIONAL under the padded layout (no sorts,
    no gathers, no tags)."""
    keys, ok = _expand_span(bucket_c, meta_c, nucs_c, k, m, b, s_max)
    cnt = jnp.where(ok, data_c, 0)
    return keys, cnt


def expand_device(state: SklState, k: int, m: int, b: int):
    """Whole finalized arena -> (keys (W, S2) INVALID-padded row-major,
    counts (S2,)). Device-resident, sort-free (padded data layout)."""
    cs, s_max, _, nw = skl_dims(k, m, b)
    F = int(state.n_fin_rows)
    R_pad = _shape_family(max(F, 1), floor=1 << 8)
    state = _ensure_span_caps(state, 0, R_pad, s_max)
    z = jnp.int32(0)
    bucket_c = jax.lax.dynamic_slice(state.bucket, (z,), (R_pad,))
    meta_c = jax.lax.dynamic_slice(state.meta, (z,), (R_pad,))
    nucs_c = jax.lax.dynamic_slice(state.nucs, (z, z), (nw, R_pad))
    data_c = jax.lax.dynamic_slice(state.data, (z,), (R_pad * s_max,))
    iota = jnp.arange(R_pad, dtype=U32)
    bucket_c = jnp.where(iota < U32(F), bucket_c, _INVALID)
    return _expand_all_padded(bucket_c, meta_c, nucs_c, data_c,
                              k=k, m=m, b=b, s_max=s_max, R_pad=R_pad)


@partial(jax.jit, static_argnames=("W",))
def _distinct_count_program(keys, W: int):
    S2 = keys.shape[1]
    out = jax.lax.sort(tuple(keys[i] for i in range(W)), num_keys=W)
    first = jnp.zeros(S2, dtype=bool).at[0].set(True)
    neq = jnp.zeros(S2, dtype=bool)
    for i in range(W):
        neq = neq | (out[i] != jnp.roll(out[i], 1))
    first = first | neq
    dead = out[0] == _INVALID
    for i in range(1, W):
        dead = dead & (out[i] == _INVALID)
    return jnp.sum(first & ~dead, dtype=jnp.int32)


def distinct_count(state: SklState, k: int, m: int, b: int) -> int:
    """EXACT number of distinct stored keys (a global key sort, off the
    hot path — chunk/segment-local consolidation leaves split counts, so
    count_nonzero(data) would overcount)."""
    if int(state.n_fin_rows) == 0:
        return 0
    keys, _ = expand_device(state, k, m, b)
    W = store.key_words(k, b)
    return int(_distinct_count_program(keys, W=W))


# -- serving lookups from the finalized arena (C8 as the backing store) --

def expanded_state(state: SklState, k: int, m: int, b: int):
    """TRANSIENT per-k-mer sorted view of the (finalized) arena for batch
    queries: expand every slot to its packed key + count (device-resident,
    expand_device), sort and consolidate into a store.IndexState that
    store.lookup can binary search. This is working memory for the
    duration of a query batch, not resident index state (the resident
    index is the arena itself)."""
    keys, counts = expand_device(state, k, m, b)
    st = store.IndexState(keys=keys, data=counts,
                          n_sorted=jnp.int32(0),
                          n_used=jnp.int32(keys.shape[1]))
    return store.compact_fast(st)


def fetch_rows(arr: jnp.ndarray, start: int, n: int) -> np.ndarray:
    """Transfer arr[start:start+n] (last axis) to host through a
    family-shaped dynamic_slice window: exact-length slices compile a
    fresh executable per distinct length. The window start is shifted
    down when it would overrun the array (dynamic_slice clamps); the
    overhang is trimmed on host."""
    size = arr.shape[-1]
    if n <= 0:
        return np.zeros(arr.shape[:-1] + (0,), dtype=arr.dtype)
    width = min(_shape_family(n, floor=1 << 4), size)
    lo = min(start, size - width)
    off = start - lo
    starts = (0,) * (arr.ndim - 1) + (lo,)
    sizes = arr.shape[:-1] + (width,)
    return np.asarray(
        jax.lax.dynamic_slice(arr, starts, sizes))[..., off:off + n]


def bucket_slice(state: SklState, bucket_id: int, segments=None,
                 bucket_col: np.ndarray = None):
    """Row ranges of one bucket across the arena's bucket-grouped
    segments (host binary search on the bucket column). `segments` is the
    list of (lo, hi) row ranges each individually bucket-sorted (one per
    finalize — the reference analog of the sorted-prefix/unsorted-tail
    split, buckets.hpp:166-189); None means one segment covering all
    finalized rows. `bucket_col` is an optional HOST cache of the bucket
    column — without it every call pays a device->host transfer of the
    whole column."""
    n = int(state.n_fin_rows)
    if segments is None:
        segments = [(0, n)]
    if bucket_col is None:
        bucket_col = fetch_rows(state.bucket, 0, n)
    out = []
    # the key in the column's dtype: a Python int makes numpy cast the
    # whole column on every search (O(n_rows) per probe)
    key = bucket_col.dtype.type(bucket_id)
    for lo, hi in segments:
        seg = bucket_col[lo:hi]
        l = lo + int(np.searchsorted(seg, key, side="left"))
        h = lo + int(np.searchsorted(seg, key, side="right"))
        if h > l:
            out.append((l, h))
    return out


def probe(state: SklState, packed_cols: np.ndarray, bucket_id: int,
          k: int, m: int, b: int, segments=None,
          bucket_col: np.ndarray = None):
    """Count lookup for a handful of packed keys known to live in one
    bucket: expand just that bucket's rows (across all segments) and sum
    counts of matching slots (the reference's find_kmer bounded scan,
    buckets.hpp:499-519, recast as a tiny dense expand+compare).
    INVARIANT (every reader relies on it): the totals of a key's
    matching slots PARTITION its true count — consolidation merges
    duplicates that share a chunk (later copies zeroed) and leaves
    split partial counts across chunks/segments/J-planes — so summing
    is exact. Returns (found (Q,) bool, counts (Q,) u32)."""
    cs, s_max, _, nw = skl_dims(k, m, b)
    ranges = bucket_slice(state, bucket_id, segments, bucket_col)
    Q = packed_cols.shape[1]
    found = np.zeros(Q, bool)
    counts = np.zeros(Q, np.uint64)
    for lo, hi in ranges:
        R = hi - lo
        Rp = 1 << max(4, (R - 1).bit_length())  # pad: reuse compiled shapes
        bucket_np = np.full(Rp, 0xFFFFFFFF, np.uint32)
        meta_np = np.zeros(Rp, np.uint32)
        nucs_np = np.zeros((state.nucs.shape[0], Rp), np.uint32)
        bucket_np[:R] = fetch_rows(state.bucket, lo, R)
        meta_np[:R] = fetch_rows(state.meta, lo, R)
        nucs_np[:, :R] = fetch_rows(state.nucs, lo, R)
        offs = fetch_rows(state.offs, lo, R).astype(np.int64)
        # rows of a segment are contiguous in data: transfer just that span
        d_lo = int(offs[0])
        d_n = min(int(offs[-1]) + s_max, state.data.shape[0]) - d_lo
        dslice = fetch_rows(state.data, d_lo, d_n)
        idx = np.clip(offs[:, None] + np.arange(s_max)[None, :] - d_lo, 0,
                      max(len(dslice) - 1, 1))
        base_count = np.zeros((Rp, s_max), np.uint32)
        base_count[:R] = dslice[idx]
        keys, cnt, val = _expand_chunk(
            jnp.asarray(bucket_np), jnp.asarray(meta_np),
            jnp.asarray(nucs_np), jnp.asarray(base_count),
            k=k, m=m, b=b, s_max=s_max)
        keys = np.asarray(keys)
        cnt = np.asarray(cnt)
        val = np.asarray(val)
        W = keys.shape[0]
        eq = np.ones((Q, keys.shape[1]), bool)
        for i in range(W):
            eq &= keys[i][None, :] == packed_cols[i][:, None]
        eq &= val[None, :]
        found |= eq.any(axis=1)
        counts += (eq * cnt[None, :].astype(np.uint64)).sum(axis=1)
    return found, counts.astype(np.uint32)


def host_cache(state: SklState) -> dict:
    """One-time host copy of the finalized arena columns for the
    serving-grade lookup path (probe_np): ~(12+4*nw) B/row + 4 B/slot,
    fetched in family-shaped transfers. Build once after finalize; every
    subsequent get()/get_many() is pure numpy — zero device round-trips
    (VERDICT r4 item 5a: the reference's find_kmer, buckets.hpp:499-519,
    is a host-memory scan too)."""
    n = int(state.n_fin_rows)
    offs = fetch_rows(state.offs, 0, n)
    need = (int(offs[-1]) + 64) if n else 64  # padded layout: last
    #                                row's slots end at offs[-1] + s_max
    return dict(
        bucket=fetch_rows(state.bucket, 0, n),
        meta=fetch_rows(state.meta, 0, n),
        nucs=fetch_rows(state.nucs, 0, n),
        offs=offs,
        data=fetch_rows(state.data, 0, min(need, state.data.shape[0])),
        n_fin_rows=n)


def _expand_rows_np(bucket, meta, nucs, k: int, m: int, b: int):
    """Numpy expansion of a small row slice to per-slot packed keys —
    the host-side mirror of _expand_one_j over all J (u64-pair u128
    math). Returns (keys (W, R*s_max) big-endian words, ok (R*s_max,)
    row-major J-minor slot order: slot r*s_max+j)."""
    from brisk_tpu.index import store as store_mod
    U64 = np.uint64
    m_reduc = m - b
    suffix_reduc = (m_reduc + 1) // 2
    cs, s_max, _, nw = skl_dims(k, m, b)
    R = bucket.shape[0]
    size = (meta & 0xFF).astype(np.int64)
    mini = ((meta >> 8) & 0xFF).astype(np.int64)
    live = bucket != 0xFFFFFFFF
    # nucs words -> (hi, lo) u64 (nt_max <= 56 bases = 112 bits)
    nu = nucs.astype(U64)
    lo = nu[0] | (nu[1] << U64(32)) if nw >= 2 else nu[0]
    hi = np.zeros(R, dtype=U64)
    if nw >= 3:
        hi = nu[2]
    if nw >= 4:
        hi |= nu[3] << U64(32)

    def shr128(h, l, s):
        s = s.astype(U64)
        with np.errstate(over="ignore"):
            big = s >= U64(64)
            s1 = np.where(big, s - U64(64), s)
            nl = np.where(big, h >> s1,
                          np.where(s1 == 0, l,
                                   (l >> s1) | (h << (U64(64) - s1))))
            nh = np.where(big, U64(0), np.where(s1 == 0, h, h >> s1))
            return nh, nl

    def shl128(h, l, s):
        s = s.astype(U64)
        with np.errstate(over="ignore"):
            big = s >= U64(64)
            s1 = np.where(big, s - U64(64), s)
            nh = np.where(big, l << s1,
                          np.where(s1 == 0, h,
                                   (h << s1) | (l >> (U64(64) - s1))))
            nl = np.where(big, U64(0), np.where(s1 == 0, l, l << s1))
            return nh, nl

    def mask128(h, l, bits):
        if bits >= 128:
            return h, l
        if bits >= 64:
            return h & U64((1 << (bits - 64)) - 1), l
        return np.zeros_like(h), l & U64((1 << bits) - 1)

    W = store_mod.key_words(k, b)
    keys = np.full((W, R * s_max), 0xFFFFFFFF, dtype=np.uint32)
    ok_all = np.zeros(R * s_max, dtype=bool)
    ones = U64(0xFFFFFFFFFFFFFFFF)
    for jj in range(s_max):
        ok = live & (jj < size)
        sh = 2 * np.where(ok, size - 1 - jj, 0)
        wh, wl = shr128(hi, lo, sh)
        wh, wl = mask128(wh, wl, 2 * cs)
        h_off = np.where(ok, mini - (size - 1 - jj), 0)
        sh_h = 2 * h_off
        # low = win & ((1 << sh_h) - 1)  (sh_h <= 2*mini <= ~110 bits)
        mh, ml = shl128(np.full(R, ones), np.full(R, ones),
                        np.asarray(sh_h))
        lh, ll = wh & ~mh, wl & ~ml
        th, tl = shr128(wh, wl, np.asarray(sh_h))
        hh, hl = shl128(th, tl, np.asarray(sh_h + 2 * b))
        bh, bl = shl128(np.zeros(R, U64), bucket.astype(U64),
                        np.asarray(sh_h))
        kh = lh | hh | bh
        kl = ll | hl | bl
        kh, kl = mask128(kh, kl, 2 * k)
        full_mini = np.where(ok, h_off - suffix_reduc, 0).astype(U64)
        # pack: bucket | kmer | mini_idx, big-endian words
        le = [np.zeros(R, dtype=np.uint32) for _ in range(W)]

        def deposit(val, bitpos, width):
            with np.errstate(over="ignore"):
                for w in range(W):
                    base = 32 * w
                    if base + 32 <= bitpos or base >= bitpos + width:
                        continue
                    if base >= bitpos:
                        word = val >> U64(base - bitpos)
                    else:
                        word = val << U64(bitpos - base)
                    le[w] |= (word & U64(0xFFFFFFFF)).astype(np.uint32)

        deposit(full_mini, 0, 8)
        deposit(kl, 8, min(64, 2 * k))
        if 2 * k > 64:
            deposit(kh, 72, 2 * k - 64)
        deposit(bucket.astype(U64), 8 + 2 * k, 2 * b)
        col = np.stack(le[::-1])
        keys[:, jj::s_max] = np.where(ok[None, :], col, 0xFFFFFFFF)
        ok_all[jj::s_max] = ok
    return keys, ok_all


PROBE_CHUNK_ROWS = 1 << 20  # arena rows probe_np expands at once


def probe_np(cache: dict, buckets: np.ndarray, packed_cols: np.ndarray,
             k: int, m: int, b: int, segments=None):
    """Serving-grade batch lookup from a host arena cache (host_cache),
    zero device work (reference find_kmer, buckets.hpp:499-519): binary
    search every queried bucket's row runs in every segment, numpy-expand
    those rows (PROBE_CHUNK_ROWS at a time) and match them against the
    queries by one lexsort per chunk. buckets (Q,), packed_cols (W, Q)
    (index.keying). Returns (found (Q,) bool, counts (Q,) u32 raw sums
    over every live slot holding the query's key)."""
    _, s_max, _, _ = skl_dims(k, m, b)
    n = cache["n_fin_rows"]
    if segments is None:
        segments = [(0, n)]
    bcol = cache["bucket"]
    # keys in the column's dtype: a Python int makes numpy cast the whole
    # column on every search
    ub = np.unique(buckets).astype(bcol.dtype)
    ls, hs = [], []
    for lo, hi in segments:
        seg = bcol[lo:hi]
        ls.append(lo + np.searchsorted(seg, ub, side="left"))
        hs.append(lo + np.searchsorted(seg, ub, side="right"))
    l, h = np.concatenate(ls), np.concatenate(hs)
    lens = np.maximum(h - l, 0)
    rows = (np.repeat(l - (np.cumsum(lens) - lens), lens)
            + np.arange(int(lens.sum())))
    Q = packed_cols.shape[1]
    found = np.zeros(Q, bool)
    counts = np.zeros(Q, np.uint64)
    for start in range(0, len(rows), PROBE_CHUNK_ROWS):
        r = rows[start:start + PROBE_CHUNK_ROWS]
        qi = np.nonzero(np.isin(buckets, bcol[r]))[0]  # never empty:
        #                              rows come from queried buckets
        keys, ok = _expand_rows_np(bcol[r], cache["meta"][r],
                                   cache["nucs"][:, r], k, m, b)
        slot = (cache["offs"][r].astype(np.int64)[:, None]
                + np.arange(s_max)[None, :])
        live_j = np.arange(s_max)[None, :] < (cache["meta"][r] & 0xFF
                                              )[:, None]
        data = np.where(live_j, cache["data"][
            np.minimum(slot, len(cache["data"]) - 1)], 0).reshape(-1)
        f, c = _match_keys_np(keys, ok, data, packed_cols[:, qi])
        found[qi] |= f
        counts[qi] += c
    return found, counts.astype(np.uint32)


def _match_keys_np(keys, ok, data, qkeys):
    """For each query key column of qkeys (W, Q): whether some live slot
    of keys (W, S) equals it, and the sum of data over those slots. Live
    slots whose last word matches no query's are dropped first (a binary
    search); the rest and the queries are lexsorted together and matched
    by runs of equal keys."""
    last = np.unique(qkeys[-1])
    pos = np.minimum(np.searchsorted(last, keys[-1]), len(last) - 1)
    cand = ok & (last[pos] == keys[-1])
    keys, ok, data = keys[:, cand], ok[cand], data[cand]
    S = keys.shape[1]
    allk = np.concatenate([keys, qkeys], axis=1)
    order = np.lexsort(tuple(allk[::-1]))  # word 0 is the primary key
    sk = allk[:, order]
    first = np.ones(order.shape[0], bool)
    first[1:] = (sk[:, 1:] != sk[:, :-1]).any(axis=0)
    starts = np.nonzero(first)[0]
    run = np.cumsum(first) - 1
    live = np.concatenate([ok, np.zeros(qkeys.shape[1], bool)])[order]
    val = np.concatenate([np.where(ok, data, 0).astype(np.uint64),
                          np.zeros(qkeys.shape[1], np.uint64)])[order]
    run_live = np.add.reduceat(live.astype(np.int64), starts) > 0
    run_sum = np.add.reduceat(val, starts)
    is_q = order >= S
    qrun = run[is_q]
    found = np.zeros(qkeys.shape[1], bool)
    counts = np.zeros(qkeys.shape[1], np.uint64)
    found[order[is_q] - S] = run_live[qrun]
    counts[order[is_q] - S] = run_sum[qrun]
    return found, counts


@partial(jax.jit, static_argnames=("k", "m", "b", "s_max"))
def _expand_join_dense(bucket_c, meta_c, nucs_c, data_c, f_live,
                       k: int, m: int, b: int, s_max: int):
    """(keys, cnt) of a FINALIZED arena for the query join — like
    _expand_dense_prefix but without tags (the join never looks at slot
    order). Scan over J emitting stacked YS (a scan-CARRY output buffer
    copies the whole buffer every step) + one live-first sort to align
    counts with data positions."""
    R = bucket_c.shape[0]
    W = store.key_words(k, b)
    n = R * s_max
    nucs_t = _nucs_tuple(bucket_c, nucs_c)
    r_iota = jnp.arange(R, dtype=U32)
    row_live = r_iota < f_live.astype(U32)

    def step(_, J):
        keys, ok = _expand_one_j(bucket_c, meta_c, nucs_t, J, k, m, b)
        ok = ok & row_live
        keys = jnp.where(ok[None, :], keys, _INVALID)
        order = jnp.where(ok, r_iota * U32(s_max) + J, _INVALID)
        return None, (keys, order)

    _, (jk, jorder) = jax.lax.scan(step, None,
                                   jnp.arange(s_max, dtype=U32))
    jk = jnp.moveaxis(jk, 0, 1).reshape(W, n)
    jorder = jorder.reshape(n)
    out = jax.lax.sort((jorder,) + tuple(jk[i] for i in range(W)),
                       num_keys=1)
    live_s = out[0] != _INVALID
    keys_s = jnp.stack([jnp.where(live_s, kk, _INVALID)
                        for kk in out[1:1 + W]])
    cnt_s = jnp.where(live_s, data_c[:n], 0)
    return keys_s, cnt_s


@partial(jax.jit, static_argnames=("k", "m", "b", "s_max"))
def _expand_join_strided(bucket_c, meta_c, nucs_c,
                         k: int, m: int, b: int, s_max: int):
    """(keys, live) of a FRESH arena for the query join — scan over J
    emitting stacked YS, J-major, no sort, no tags."""
    R = bucket_c.shape[0]
    W = store.key_words(k, b)
    n = R * s_max
    nucs_t = _nucs_tuple(bucket_c, nucs_c)

    def step(_, J):
        keys, ok = _expand_one_j(bucket_c, meta_c, nucs_t, J, k, m, b)
        keys = jnp.where(ok[None, :], keys, _INVALID)
        return None, (keys, ok.astype(U32))

    _, (jk, jc) = jax.lax.scan(step, None, jnp.arange(s_max, dtype=U32))
    return (jnp.moveaxis(jk, 0, 1).reshape(W, n), jc.reshape(n))


def expand_for_join(state: SklState, k: int, m: int, b: int):
    """(keys (W, S), counts (S,)) of an arena for the query join. The
    arena must be fully finalized (padded positional counts,
    expand_device) or fully fresh (counts = 1 per live slot)."""
    cs, s_max, _, nw = skl_dims(k, m, b)
    F = int(state.n_fin_rows)
    N = int(state.n_rows)
    if F == N:  # finalized index
        return expand_device(state, k, m, b)
    assert F == 0, "join expansion needs a fully fresh or finalized arena"
    R_pad = _shape_family(max(N, 1), floor=1 << 8)
    if R_pad > state.bucket.shape[0]:
        state = grow(state, 1 << (R_pad - 1).bit_length(),
                     state.data.shape[0])
    bucket_c = jax.lax.dynamic_slice(state.bucket, (0,), (R_pad,))
    meta_c = jax.lax.dynamic_slice(state.meta, (0,), (R_pad,))
    nucs_c = jax.lax.dynamic_slice(state.nucs, (0, 0),
                                   (state.nucs.shape[0], R_pad))
    return _expand_join_strided(bucket_c, meta_c, nucs_c,
                                k=k, m=m, b=b, s_max=s_max)


@jax.jit
def _query_join_partials(ikeys, icnt, qkeys, qlive):
    """Sum of index counts over a batch of query slots via ONE
    sort-merge join (the binary-search lookup was a 27-step gather per
    batch). The side TAG rides as the shifted-in
    LSB of the packed key (the key layout reserves spare top bits, so
    key << 1 is lossless) and the two payloads (index count / query
    liveness) share one word — the sort moves 4 operands with 3 key
    words instead of round 4's 6 operands with 4 keys (the join sort was
    the measured query wall). Index slots (tag 0) sort before query
    slots (tag 1) of the same key; a segmented cumsum of index counts
    hands each query slot its key's total (the consolidation invariant
    makes per-key index sums exact even with zero-count or
    partial-count duplicate slots). Returns (256,) u32 partial sums of
    (count mod 256) per query emission — host sums them as python ints
    (a single u32/f32 accumulator would overflow/lose precision at
    ~50M x 255)."""
    W = ikeys.shape[0]
    Si = ikeys.shape[1]
    Sq = qkeys.shape[1]
    S = Si + Sq

    def shifted(keys, tagbit):
        out = []
        for i in range(W):
            w = keys[i] << U32(1)
            if i + 1 < W:
                w = w | (keys[i + 1] >> U32(31))
            else:
                w = w | U32(tagbit)
            out.append(w)
        return out

    ik_s = shifted(ikeys, 0)
    qk_s = shifted(qkeys, 1)
    keys = tuple(jnp.concatenate([ik_s[i], qk_s[i]]) for i in range(W))
    payload = jnp.concatenate([icnt, qlive.astype(U32)])
    out = jax.lax.sort(keys + (payload,), num_keys=W)
    s_pay = out[W]
    is_q = (out[W - 1] & U32(1)) == U32(1)
    first = jnp.zeros(S, dtype=bool).at[0].set(True)
    neq = jnp.zeros(S, dtype=bool)
    for i in range(W):
        a = out[i]
        b = jnp.roll(out[i], 1)
        if i == W - 1:  # ignore the tag bit when detecting key runs
            a = a & ~U32(1)
            b = b & ~U32(1)
        neq = neq | (a != b)
    first = first | neq
    contrib = jnp.where(~is_q, s_pay, 0)
    c = jnp.cumsum(contrib, dtype=jnp.uint32)
    # csum at each run's start, propagated forward (csum is monotone,
    # so a cummax of run-start snapshots is exactly the forward fill)
    base = jax.lax.cummax(jnp.where(first, c - contrib, 0))
    filled = c - base
    vals = jnp.where(is_q & (s_pay == U32(1)), filled % U32(256), 0)
    # two-level sum: (256, S/256) row sums stay under 2^32
    Xp = 256
    pad = (-S) % Xp
    vals = jnp.pad(vals, (0, pad)).reshape(Xp, -1)
    return jnp.sum(vals, axis=1, dtype=jnp.uint32)


def query_join_total(state: SklState, qstate_box: list,
                     k: int, m: int, b: int) -> int:
    """Total stored count over every k-mer emission of a QUERY arena
    (un-finalized: each emission is one cnt=1 slot) against a FINALIZED
    index arena. Both sides expand device-resident; the join is chunked
    over the query slots to bound peak device memory (index arena +
    both expansions + one join chunk's sort workspace; the chunking was
    sized for a 16 GB device, to retune on the H100, ROADMAP S5/S6).

    qstate_box: single-element list holding the query SklState — the
    callee takes OWNERSHIP (pops and frees the ~1 GB row arena right
    after its expansion; a plain argument would stay pinned by the
    caller's frame)."""
    # ORDER MATTERS for peak device memory: expand the index while the
    # query side holds only its row arena, trim the index expansion to
    # its dense live prefix and FREE the untrimmed buffers, THEN expand
    # the query side.
    ik, icnt = expand_for_join(state, k, m, b)
    qstate = qstate_box.pop()
    qk, qcnt = expand_for_join(qstate, k, m, b)
    del qstate
    Sq = qk.shape[1]
    CQ = min(Sq, 1 << 26)
    total = 0
    for start in range(0, Sq, CQ):
        qc = qk[:, start:start + CQ]
        ql = qcnt[start:start + CQ]
        pad = CQ - qc.shape[1]
        if pad:  # keep one compiled shape per (Si, CQ)
            qc = jnp.pad(qc, ((0, 0), (0, pad)),
                         constant_values=np.uint32(0xFFFFFFFF))
            ql = jnp.pad(ql, (0, pad))
        part = _query_join_partials(ik, icnt, qc, ql)
        total += int(np.asarray(part, dtype=np.uint64).sum())
    return total


def query_join_keys_total(state: SklState, qk, qlive,
                          k: int, m: int, b: int,
                          chunk: int = 1 << 26) -> int:
    """Total stored count over a batch of query PACKED KEYS against a
    FINALIZED arena — the shadow-index-free query path (VERDICT r4
    item 6): the caller enumerates the query file straight to packed
    keys; no second arena is built. qk (W, Sq) u32, qlive (Sq,)
    u32/bool. Chunked over the query slots to bound peak HBM."""
    ik, icnt = expand_for_join(state, k, m, b)
    Sq = qk.shape[1]
    CQ = min(_shape_family(max(Sq, 1)), chunk)
    total = 0
    for start in range(0, Sq, CQ):
        qc = jnp.asarray(qk[:, start:start + CQ])
        ql = jnp.asarray(qlive[start:start + CQ]).astype(U32)
        pad = CQ - qc.shape[1]
        if pad:  # keep one compiled shape per (Si, CQ)
            qc = jnp.pad(qc, ((0, 0), (0, pad)),
                         constant_values=np.uint32(0xFFFFFFFF))
            ql = jnp.pad(ql, (0, pad))
        part = _query_join_partials(ik, icnt, qc, ql)
        total += int(np.asarray(part, dtype=np.uint64).sum())
    return total


@partial(jax.jit, static_argnames=("k", "m", "b"))
def _rows_from_keys(keys: jnp.ndarray, k: int, m: int, b: int):
    """Packed per-kmer keys (W, N) -> size-1 skl rows (bucket, meta,
    nucs)."""
    m_reduc = m - b
    suffix_reduc = (m_reduc + 1) // 2
    cs, _, _, nw = skl_dims(k, m, b)
    W = keys.shape[0]
    le = tuple(keys[W - 1 - i] for i in range(W))
    mini_full = le[0] & U32(0xFF)
    kmer_all = u128.shr(le, 8)
    zero = jnp.zeros_like(le[0])
    kmer4 = u128.mask_bits(tuple(kmer_all[i] if i < len(kmer_all) else zero
                                 for i in range(4)), 2 * k)
    bucket_limbs = u128.shr(le, 8 + 2 * k)
    bucket = bucket_limbs[0] & U32((1 << (2 * b)) - 1)

    h = mini_full + U32(suffix_reduc)
    sh_h = U32(2) * h
    hi_part = u128.shl_var(u128.shr_var(kmer4, sh_h + U32(2 * b)), sh_h)
    lo_part = u128.band(kmer4, _ones_mask_var(sh_h, 4))
    cmp4 = u128.mask_bits(u128.bor(hi_part, lo_part), 2 * cs)
    nucs = jnp.stack([cmp4[i] if i < 4 else zero for i in range(nw)])
    meta = U32(1) | (h << U32(8))
    return bucket, meta, nucs


def from_entries(state, k: int, m: int, b: int,
                 chunk: int = 1 << 20) -> SklState:
    """Rebuild a (finalized) arena of size-1 rows from a compacted
    per-kmer IndexState — used after reallocate, where the new minimizer
    decomposition invalidates old super-k-mer groupings (the reference's
    reallocate likewise re-inserts k-mer by k-mer, Brisk.hpp:210-219)."""
    cs, s_max, nt_max, nw = skl_dims(k, m, b)
    n = int(state.n_sorted)
    keys_np = np.asarray(state.keys)[:, :n]
    counts_np = np.asarray(state.data)[:n]
    live = counts_np != 0
    keys_np = keys_np[:, live]
    counts_np = counts_np[live]
    n_live = keys_np.shape[1]
    rcap = max(1024, 1 << max(0, (max(n_live, 1) - 1).bit_length()))
    out_b = np.full(rcap, 0xFFFFFFFF, dtype=np.uint32)
    out_m = np.zeros(rcap, dtype=np.uint32)
    out_n = np.zeros((nw, rcap), dtype=np.uint32)
    for start in range(0, n_live, chunk):
        end = min(start + chunk, n_live)
        bb, mm, nn = _rows_from_keys(jnp.asarray(keys_np[:, start:end]),
                                     k=k, m=m, b=b)
        out_b[start:end] = np.asarray(bb)
        out_m[start:end] = np.asarray(mm)
        out_n[:, start:end] = np.asarray(nn)
    # PADDED data layout (round 5): row r's counts at data[r*s_max + j]
    kcap = _shape_family(max(1024, rcap * s_max))
    data = np.zeros(kcap, dtype=np.uint32)
    data[0:n_live * s_max:s_max] = counts_np
    offs = (np.arange(rcap, dtype=np.uint32) * np.uint32(s_max))
    return SklState(
        bucket=jnp.asarray(out_b), meta=jnp.asarray(out_m),
        nucs=jnp.asarray(out_n), data=jnp.asarray(data),
        offs=jnp.asarray(offs), n_rows=jnp.int32(n_live),
        n_fin_rows=jnp.int32(n_live), n_fin_kmers=jnp.int32(n_live))


def stats(state: SklState, k: int, m: int, b: int) -> dict:
    n = int(state.n_fin_rows)
    nk = int(state.n_fin_kmers)
    cs, s_max, _, nw = skl_dims(k, m, b)
    live_counts = distinct_count(state, k, m, b)
    # rows (bucket+meta+nucs words) + PADDED u8 count slots; the offs
    # column is fully derivable (offs[r] = r*s_max) and not part of the
    # storage format
    resident = (8 + 4 * nw) * max(n, 1) + n * s_max
    return dict(nb_superkmer_rows=n, nb_slots=nk,
                nb_live_kmers=live_counts,
                avg_kmers_per_skl=(nk / n) if n else 0.0,
                resident_bytes=resident,
                bytes_per_kmer=(resident / live_counts) if live_counts
                else 0.0)
