"""Fused multi-batch insert pipeline.

The per-batch path (enumerate -> make_keys -> append) is three dispatches
per batch, and host round-trips can dominate the device time. This
module fuses a whole stack of batches into
ONE jitted program: a lax.scan whose carry is (IndexState, MinimizerState),
with the index buffers donated so appends update device memory in place.

This is the device-program analog of the reference's per-thread inner loop
(count_sequence, counter.cpp:231-270): the reference amortizes work per
OpenMP thread; we amortize per device program.
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from brisk_tpu.index import store
from brisk_tpu.ops import enumerate as enum_ops
from brisk_tpu.ops.minimizer import MinimizerState


def zero_chain():
    """Initial window-continuity chain carry: (predecessor end state of
    the LAST lane processed so far — MinimizerState of scalar leaves —
    and whether that state is exact). Host passes this at the start of an
    insert stream; each flush returns the updated chain for the next."""
    z = jnp.uint32(0)
    return (MinimizerState(z, z, z, jnp.asarray(False), z, z, z),
            jnp.asarray(False))


def _chain_exact(em, end, vs_i, chain, margin: int):
    """End-state EQUALITY certificate, chained across lanes (VERDICT r2
    item 4): a window is exact iff its warm-up replay re-derived the TRUE
    machine state at its first valid position. em.cert gives the
    content-local proofs (unique window minimum for k <= 32; window 0 of
    a record always). On top, lane j is also exact when its replayed
    state at valid_start-1 EQUALS lane j-1's end state AND lane j-1 is
    exact — the replayed state is then the true sequential state, quirk
    or no quirk (this is what unlocks k > 32 sequence parallelism, the
    truncation quirk never enters the argument).

    exact_j = u_j | (q_j & exact_{j-1}) is a boolean linear recurrence;
    composed over a lane prefix it stays the same form, so one
    associative_scan evaluates all lanes. `chain` carries the previous
    batch's last-lane (end state, exactness) across batches/flushes as
    DEVICE values — no host sync.

    Returns (exact (B,) bool, new_chain)."""
    prev_end, prev_exact = chain
    shift = lambda c, e: jnp.concatenate([jnp.asarray(c)[None].astype(
        e.dtype), e[:-1]])
    pred = MinimizerState(*(shift(c, e) for c, e in zip(prev_end, end)))
    eq = jnp.ones(vs_i.shape, dtype=bool)
    for a, bfield in zip(em.replay, pred):
        eq = eq & (a == bfield)
    u = em.cert
    q = eq & (vs_i != margin)  # window-0 lanes certify via u alone

    def comb(a, bb):  # bb is the LATER element
        return (bb[0] | (bb[1] & a[0]), bb[1] & a[1])

    U, Q = jax.lax.associative_scan(comb, (u, q))
    exact = U | (Q & prev_exact)
    new_chain = (MinimizerState(*(e[-1] for e in end)), exact[-1])
    return exact, new_chain


@partial(jax.jit, static_argnames=("k", "m", "b"), donate_argnums=(0,))
def insert_many(state: store.IndexState, carry: MinimizerState,
                codes: jnp.ndarray, fresh: jnp.ndarray,
                valid_end: jnp.ndarray, k: int, m: int, b: int
                ) -> Tuple[store.IndexState, MinimizerState, jnp.ndarray]:
    """Insert a stack of enumerator batches in one device program.

    codes:     (S, B, L_buf) uint32 2-bit codes
    fresh:     (S, B) bool
    valid_end: (S, B) int32

    Returns (state', carry', n_superkmers) where n_superkmers counts
    super-k-mer starts across the stack (boundary emissions plus one per
    fresh non-empty lane, mirroring api.Brisk._insert_batches).

    PRECONDITIONS (callers MUST enforce host-side; inside jit the
    dynamic_update_slice in store.append clamps out-of-bounds offsets and
    would silently overwrite the index tail):
      * capacity: state.n_used + S*B*(L_buf - (k-1)) <= cap — call
        store.ensure_room(state, S*B*L_out) (and compact first if the
        deduped size allows) before invoking.
      * donation: the input `state` buffers are DONATED (donate_argnums)
        and must not be reused by the caller after this call.
    """
    def step(sc, xs):
        st, cy = sc
        codes_i, fresh_i, ve_i = xs
        em, cy = enum_ops.enumerate_batch(codes_i, fresh_i, ve_i, cy,
                                          k=k, m=m, b=b)
        rows = store.make_keys(em.bucket.reshape(-1),
                               em.key.reshape(4, -1),
                               em.mini_idx.reshape(-1), k, b)
        valid = em.valid.reshape(-1)
        st = store.append(st, rows,
                          jnp.ones(rows.shape[1], dtype=jnp.uint32), valid)
        n_sk = (jnp.sum(em.boundary & em.valid)
                + jnp.sum(fresh_i & (ve_i > 0))).astype(jnp.int32)
        return (st, cy), n_sk

    (state, carry), n_sks = jax.lax.scan(
        step, (state, carry), (codes, fresh, valid_end))
    return state, carry, jnp.sum(n_sks)


@partial(jax.jit, static_argnames=("k", "m", "b"), donate_argnums=(0,))
def insert_windows(state: store.IndexState, codes: jnp.ndarray,
                   valid_start: jnp.ndarray, valid_end: jnp.ndarray,
                   chain, k: int, m: int, b: int
                   ) -> Tuple[store.IndexState, jnp.ndarray, jnp.ndarray]:
    """Insert a stack of sequence-parallel WINDOW batches (io.windows) in
    one device program. Unlike insert_many there is NO carry: every lane
    is an independent window with its own warm-up replay, so the stack is
    a pure scan over the index state only.

    codes:       (S, B, L_buf) uint8/uint32 2-bit codes
    valid_start: (S, B) int32   first valid emission position per lane
    valid_end:   (S, B) int32   one past the last valid position

    Lanes whose warm-up replay failed to re-sync (no unique-window-minimum
    certificate, see io.windows) contribute NOTHING; their `cert` flag is
    returned False and the caller must re-run them exactly through the
    streaming carry path (api.Brisk._repair_windows).

    Returns (state', n_superkmer_boundaries, n_kmers, cert (S, B) bool,
    end_states MinimizerState of (S, B) leaves — the per-lane machine
    state at the end of each window buffer, exact for certified lanes and
    used to seed repairs of their successors). Callers add one super-k-mer
    per record (window 0's first boundary is suppressed by the fresh-lane
    rule) and must honor the same capacity/donation preconditions as
    insert_many (cap >= n_used + S*B*L_out; donated input state).
    """
    B = codes.shape[1]
    margin = k - 1
    fresh = jnp.ones((B,), dtype=bool)
    zero = enum_ops.zero_carry(B)

    def step(carry, xs):
        st, ch = carry
        codes_i, vs_i, ve_i = xs
        em, end = enum_ops.enumerate_batch(codes_i, fresh, ve_i, zero,
                                           k=k, m=m, b=b, valid_start=vs_i)
        exact, ch = _chain_exact(em, end, vs_i, ch, margin)
        rows = store.make_keys(em.bucket.reshape(-1),
                               em.key.reshape(4, -1),
                               em.mini_idx.reshape(-1), k, b)
        valid = (em.valid & exact[:, None]).reshape(-1)
        st = store.append(st, rows,
                          jnp.ones(rows.shape[1], dtype=jnp.uint32), valid)
        n_sk = jnp.sum(em.boundary & em.valid & exact[:, None]
                       ).astype(jnp.int32)
        n_km = jnp.sum(valid).astype(jnp.int32)
        return (st, ch), (n_sk, n_km, exact, end)

    (state, chain), (n_sks, n_kms, certs, ends) = jax.lax.scan(
        step, (state, chain), (codes, valid_start, valid_end))
    return state, jnp.sum(n_sks), jnp.sum(n_kms), certs, ends, chain


def _unpack4_device(codes4: jnp.ndarray, l_buf: int) -> jnp.ndarray:
    """Packed (B, L4) uint8 (4 bases/byte, first base in the low bits) ->
    (B, l_buf) uint32 2-bit codes. Three shifts + an interleaving
    stack/reshape — no gather (the packed transport moves 4x fewer
    host->device bytes; see io.windows)."""
    c = codes4.astype(jnp.uint32)
    un = jnp.stack([c & 3, (c >> 2) & 3, (c >> 4) & 3, (c >> 6) & 3],
                   axis=-1)
    return un.reshape(c.shape[0], -1)[:, :l_buf]


def _skl_window_scan(skl, codes: jnp.ndarray, valid_start: jnp.ndarray,
                     valid_end: jnp.ndarray, chain,
                     k: int, m: int, b: int, row_cap: int, l_buf: int):
    """Shared scan body of the windowed skl insert programs (see
    insert_windows_sklnative for the contract). codes is (S, B, l_buf4)
    packed when l_buf > 0, else (S, B, L_buf) unpacked."""
    from brisk_tpu.index import sklstore

    S, B, _L = codes.shape
    L_buf = l_buf if l_buf else _L
    margin = k - 1
    fresh = jnp.ones((B,), dtype=bool)
    zero = enum_ops.zero_carry(B)
    pos_out = jnp.arange(margin, L_buf, dtype=jnp.uint32)[None, :]
    nw = skl.nucs.shape[0]
    R = B * row_cap
    _INV = np.uint32(0xFFFFFFFF)

    def step(carry, xs):
        sk, ch = carry
        codes_i, vs_i, ve_i = xs
        if l_buf:
            codes_i = _unpack4_device(codes_i, l_buf)
        em, end = enum_ops.enumerate_batch(codes_i, fresh, ve_i, zero,
                                           k=k, m=m, b=b, valid_start=vs_i)
        exact, ch = _chain_exact(em, end, vs_i, ch, margin)
        ok = em.valid & exact[:, None]
        first_valid = pos_out == vs_i[:, None].astype(jnp.uint32)
        rb, rm, rn, ovf = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, ok,
            first_valid, em.boundary, k, m, b, row_cap)
        rb_f = rb.reshape(R)
        live = rb_f != _INV
        # live-first stable order (genome order preserved within the flush)
        order = jnp.where(live, jnp.arange(R, dtype=jnp.uint32), _INV)
        out = jax.lax.sort(
            (order, rb_f, rm.reshape(R))
            + tuple(rn.reshape(nw, R)[i] for i in range(nw)), num_keys=1)
        n_live = jnp.sum(live).astype(jnp.int32)
        sk = sklstore.append_n(sk, out[1], out[2], jnp.stack(out[3:]),
                               n_live)
        n_sk = jnp.sum(em.boundary & ok).astype(jnp.int32)
        n_km = jnp.sum(ok).astype(jnp.int32)
        # cert+overflow packed IN-PROGRAM: an eager `cert | ovf << 1`
        # after the call would cost 3 tiny op dispatches per flush
        flags = exact.astype(jnp.uint8) | (ovf.astype(jnp.uint8) << 1)
        return (sk, ch), (n_sk, n_km, flags, end)

    (skl, chain), (n_sks, n_kms, flags, ends) = jax.lax.scan(
        step, (skl, chain), (codes, valid_start, valid_end))
    return (skl, jnp.sum(n_sks), jnp.sum(n_kms), flags, ends,
            skl.n_rows + jnp.int32(0), chain)


@partial(jax.jit,
         static_argnames=("k", "m", "b", "row_cap", "l_buf", "useful"),
         donate_argnums=(0,))
def insert_flat_sklnative(skl, chunk4: jnp.ndarray,
                          valid_start: jnp.ndarray,
                          valid_end: jnp.ndarray, chain,
                          k: int, m: int, b: int,
                          row_cap: int, l_buf: int, useful: int):
    """THE product insert program (k <= 32, round 5): ships ONE contiguous
    packed chunk per flush and builds the overlapping window lanes
    ON-DEVICE — each base crosses the host->device link exactly once,
    and the host never runs a per-window copy loop (VERDICT r4 item 1;
    reference e2e identity: counter.cpp:375-404).

    chunk4:      ((S*B + ext) * useful4,) uint8 — packed 2-bit codes,
                 window j of the flush at byte offset j*useful4
                 (io.windows.WindowPacker.pack_flat)
    valid_start: (S, B) int32; valid_end: (S, B) int32

    Window construction is gather-free: the chunk reshapes into
    useful4-wide rows and the l_buf4-wide overlapping windows are
    `nparts` statically-shifted row slices concatenated along the byte
    axis. Returns the insert_windows_sklnative tuple:
    (skl', n_sk, n_km, flags (S, B) u8 [bit0 = certified, bit1 = skl row
    overflow], ends, n_rows_after, chain')."""
    S, B = valid_start.shape
    SB = S * B
    u4 = useful // 4
    lb4 = -(-l_buf // 4)
    nparts = -(-lb4 // u4)
    rows = chunk4.reshape(SB + nparts - 1, u4)
    win4 = jnp.concatenate([rows[s:s + SB] for s in range(nparts)],
                           axis=1)[:, :lb4]
    codes = win4.reshape(S, B, lb4)
    return _skl_window_scan(skl, codes, valid_start, valid_end, chain,
                            k=k, m=m, b=b, row_cap=row_cap, l_buf=l_buf)


@partial(jax.jit, static_argnames=("k", "m", "b", "row_cap", "l_buf"),
         donate_argnums=(0,))
def insert_windows_sklnative(skl, codes: jnp.ndarray,
                             valid_start: jnp.ndarray,
                             valid_end: jnp.ndarray, chain,
                             k: int, m: int, b: int,
                             row_cap: int, l_buf: int = 0):
    """THE product insert program (k <= 32): sequence-parallel window
    stack -> compacted super-k-mer rows ONLY. No per-k-mer store — the skl
    arena IS the index (the reference's Bucket<DATA> stores nothing but
    SKL records + arenas either, buckets.hpp:19-58); per-k-mer counts are
    consolidated lazily by sklstore.finalize.

    Each batch: enumerate -> segment into super-k-mer rows (up to row_cap
    per lane) -> flush-global live-first sort -> DENSE append (the arena
    never holds tombstones; round 2's per-flush compress_rows full sorts
    are gone, VERDICT r2 item 1).

    `chain` threads the window-continuity equality certificate across
    batches AND flushes (see _chain_exact / zero_chain) — all device
    values, no host sync. Returns (skl', n_sk, n_km, flags (S, B) u8
    [bit0 = certified, bit1 = skl row overflow], ends, n_rows_after,
    chain'). n_sk counts super-k-mer
    boundaries (for stats parity), NOT rows. n_rows_after is a FRESH
    scalar (safe to read back after the returned skl has been donated to
    the next flush). Preconditions: skl donated; skl.n_rows + S*B*row_cap
    <= rcap for EVERY step of the stack (host tracks an upper bound and
    grows ahead of time).

    codes is PACKED (S, B, l_buf4) uint8 (io.windows.pack4) when l_buf>0
    is passed; legacy unpacked (S, B, L_buf) input is accepted with
    l_buf=0 (tests)."""
    return _skl_window_scan(skl, codes, valid_start, valid_end, chain,
                            k=k, m=m, b=b, row_cap=row_cap, l_buf=l_buf)


@partial(jax.jit, static_argnames=("k", "m", "b", "row_cap"),
         donate_argnums=(0,))
def insert_stream_sklnative(skl, codes: jnp.ndarray, fresh: jnp.ndarray,
                            valid_end: jnp.ndarray, carry,
                            k: int, m: int, b: int, row_cap: int):
    """THE k > 32 product insert program: one RECORD per lane with the
    exact streaming carry (MinimizerState) across batches and flushes —
    sequentially exact by construction, so the k > 32 truncation quirk
    never needs a certificate and NOTHING repairs (the windowed path's
    equality chain starves at k > 32: the quirk poisons stored-hash
    comparisons, so a warm-up replay only re-syncs at rare expiry
    alignments — ~30-99% of windows repaired depending on window size).
    Data-parallel across records, which is the scale story for real
    read sets; one giant chromosome at k > 32 degrades to few lanes
    (use the windowed path for that shape of input).

    codes (S, B, L_buf) u8/u32 unpacked; fresh/valid_end (S, B); carry
    MinimizerState of (B,) leaves. Rows split at batch seams (same
    content, counts unaffected). Returns (skl', n_sk, n_km, carry',
    n_rows_after)."""
    from brisk_tpu.index import sklstore

    S, B, L_buf = codes.shape
    margin = k - 1
    nw = skl.nucs.shape[0]
    R = B * row_cap
    _INV = np.uint32(0xFFFFFFFF)
    pos_out = jnp.arange(margin, L_buf, dtype=jnp.uint32)[None, :]

    def step(carry_t, xs):
        sk, cy = carry_t
        codes_i, fresh_i, ve_i = xs
        em, cy = enum_ops.enumerate_batch(codes_i, fresh_i, ve_i, cy,
                                          k=k, m=m, b=b)
        # every lane's first valid emission starts a row (batch seams
        # split super-k-mers exactly like window seams)
        first_valid = jnp.broadcast_to(pos_out == jnp.uint32(margin),
                                       em.valid.shape)
        rb, rm, rn, ovf = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, em.valid,
            first_valid, em.boundary, k, m, b, row_cap)
        rb_f = rb.reshape(R)
        live = rb_f != _INV
        order = jnp.where(live, jnp.arange(R, dtype=jnp.uint32), _INV)
        out = jax.lax.sort(
            (order, rb_f, rm.reshape(R))
            + tuple(rn.reshape(nw, R)[i] for i in range(nw)), num_keys=1)
        n_live = jnp.sum(live).astype(jnp.int32)
        sk = sklstore.append_n(sk, out[1], out[2], jnp.stack(out[3:]),
                               n_live)
        n_sk = (jnp.sum(em.boundary & em.valid)
                + jnp.sum(fresh_i & (ve_i > 0))).astype(jnp.int32)
        n_km = jnp.sum(em.valid).astype(jnp.int32)
        return (sk, cy), (n_sk, n_km)

    (skl, carry), (n_sks, n_kms) = jax.lax.scan(
        step, (skl, carry), (codes, fresh, valid_end))
    return (skl, jnp.sum(n_sks), jnp.sum(n_kms), carry,
            skl.n_rows + jnp.int32(0))


@partial(jax.jit, static_argnames=("k", "m", "b", "width"),
         donate_argnums=(0,))
def insert_windows_payload(state, codes: jnp.ndarray,
                           valid_start: jnp.ndarray,
                           valid_end: jnp.ndarray, pos0: jnp.ndarray,
                           chain, k: int, m: int, b: int, width: int):
    """Sequence-parallel windowed insert for GENERIC payload states
    (index.payload, the `Brisk<DATA>` analog): per emission, lane 0 gets
    +1 (count) and lanes 1.. get the k-mer's RECORD POSITION
    pos0[lane] + (p - margin) — the canonical (count, position) payload;
    merge semantics are applied by payload.compact's lane kinds.

    codes/valid_start/valid_end: (S, B, L_buf)/(S, B); pos0 (S, B) u32 is
    each window's first k-mer index within its record (win * useful).
    Same window-continuity chain as insert_windows. Returns (state',
    n_km, cert, ends, chain')."""
    from brisk_tpu.index import payload as payload_mod

    S, B, L_buf = codes.shape
    margin = k - 1
    fresh = jnp.ones((B,), dtype=bool)
    zero = enum_ops.zero_carry(B)
    pos_idx = jnp.arange(margin, L_buf, dtype=jnp.uint32)[None, :]

    def step(carry, xs):
        st, ch = carry
        codes_i, vs_i, ve_i, pos0_i = xs
        em, end = enum_ops.enumerate_batch(codes_i, fresh, ve_i, zero,
                                           k=k, m=m, b=b, valid_start=vs_i)
        exact, ch = _chain_exact(em, end, vs_i, ch, margin)
        rows = store.make_keys(em.bucket.reshape(-1),
                               em.key.reshape(4, -1),
                               em.mini_idx.reshape(-1), k, b)
        valid = (em.valid & exact[:, None]).reshape(-1)
        pos = (pos0_i[:, None] + (pos_idx - jnp.uint32(margin))).reshape(-1)
        vals = jnp.concatenate(
            [jnp.ones((1, rows.shape[1]), dtype=jnp.uint32)]
            + [pos[None]] * (width - 1))
        st = payload_mod.append(st, rows, vals, valid)
        n_km = jnp.sum(valid).astype(jnp.int32)
        return (st, ch), (n_km, exact, end)

    (state, chain), (n_kms, certs, ends) = jax.lax.scan(
        step, (state, chain), (codes, valid_start, valid_end, pos0))
    return state, jnp.sum(n_kms), certs, ends, chain
