"""Multi-chip sharded index: data-parallel reads, minimizer-space sharding.

The reference's only concurrency story is OpenMP threads + per-minimizer
lock groups in shared memory (DenseMenuYo.hpp:110-118). The device-mesh
equivalent (SURVEY §2 parallelism table):

  * record lanes are DATA-PARALLEL across chips (each chip enumerates its
    own shard of the batch);
  * the index is sharded by REDUCED MINIMIZER: chip d owns every bucket
    with bucket % n_shards == d (the modulo mirrors the reference's
    `minimizer % mutex_number` lock-group keying, DenseMenuYo.hpp:150);
  * emissions are routed to their owner chip with a capacity-bounded
    lax.all_to_all over the mesh axis, then appended to the owner's local
    log — the lock-free batch analog of insert_kmer_vector under
    MutexBucket.

Everything is one jitted shard_map step: (sharded index, sharded batch,
sharded carry) -> (sharded index', sharded carry', stats).

Skew handling (the GROGRO analog, DenseMenuYo.hpp:216-240): rows beyond a
destination's routing capacity are never dropped — they SPILL to their
source shard's own log. Ownership (bucket % n_shards == shard) is a
routing heuristic, not a correctness invariant: per-shard compaction
consolidates whatever lives on a shard, and sharded_lookup sums each key's
counts across ALL shards, so a key split between its owner and spill
shards still reads back its exact total.
"""

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from brisk_tpu.index import sklstore, store
from brisk_tpu.ops import enumerate as enum_ops
from brisk_tpu.ops.minimizer import MinimizerState

U32 = np.uint32  # numpy scalar: avoids device-constant embedding at trace time
_INVALID = U32(0xFFFFFFFF)


class ShardedStats(NamedTuple):
    n_emitted: jnp.ndarray   # global emissions this step
    n_routed: jnp.ndarray    # rows that fit the routing capacity
    n_spilled: jnp.ndarray   # rows kept on their SOURCE shard (skew
    #                          overflow; the GROGRO analog, see module doc)
    n_boundaries: jnp.ndarray


def make_mesh(n_devices: int) -> Mesh:
    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise ValueError(
            f"need {n_devices} devices, have {len(jax.devices())}")
    return Mesh(devices, axis_names=("x",))


def _route_local(rows: jnp.ndarray, bucket: jnp.ndarray, valid: jnp.ndarray,
                 n_shards: int, cap: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pack (W, N) packed-key rows into an (n_shards, cap, W) routing
    buffer by destination shard (bucket % n_shards).

    Returns (buffer, routed_mask (N,) bool in ORIGINAL row order): rows
    beyond a destination's capacity are NOT dropped — the caller appends
    them to the SOURCE shard's own log (the spill path; replicated-query
    lookup and per-shard compaction make ownership violations harmless,
    see sharded_lookup)."""
    W = rows.shape[0]
    n = rows.shape[1]
    dest = jnp.where(valid, bucket % U32(n_shards), U32(n_shards))
    # per-destination running rank, original order (n_shards is small)
    rank = jnp.zeros(n, dtype=jnp.int32)
    for d in range(n_shards):
        is_d = dest == U32(d)
        rank = jnp.where(is_d, jnp.cumsum(is_d) - 1, rank)
    ok = valid & (rank < cap)
    flat = jnp.where(ok, dest.astype(jnp.int32) * cap + rank,
                     n_shards * cap)
    buf = jnp.full((n_shards * cap, W), _INVALID, dtype=U32)
    buf = buf.at[flat].set(rows.T, mode="drop")
    return buf.reshape(n_shards, cap, W), ok


@partial(jax.jit,
         static_argnames=("k", "m", "b", "mesh", "route_cap"))
def sharded_insert_step(state: store.IndexState, codes: jnp.ndarray,
                        fresh: jnp.ndarray, valid_end: jnp.ndarray,
                        carry: MinimizerState, k: int, m: int, b: int,
                        mesh: Mesh, route_cap: int
                        ) -> Tuple[store.IndexState, MinimizerState,
                                   ShardedStats]:
    """One distributed insert step over mesh axis "x".

    Sharded shapes (global):
      state.keys (n, W, cap), state.data (n, cap), state.n_* (n,)
      codes (B, L_buf) with B = n * B_local; fresh/valid_end (B,)
      carry: MinimizerState of (B,) arrays
    """
    n_shards = mesh.shape["x"]

    def step(st_keys, st_data, st_ns, st_nu, codes, fresh, valid_end,
             carry):
        # drop the leading shard axis of the index state
        local = store.IndexState(st_keys[0], st_data[0], st_ns[0], st_nu[0])
        em, carry2 = enum_ops.enumerate_batch(
            codes, fresh, valid_end, carry, k=k, m=m, b=b)
        key = em.key.reshape(4, -1)
        rows = store.make_keys(em.bucket.reshape(-1), key,
                               em.mini_idx.reshape(-1), k, b)
        valid = em.valid.reshape(-1)

        buf, routed_mask = _route_local(rows, em.bucket.reshape(-1),
                                        valid, n_shards, route_cap)
        routed = jax.lax.all_to_all(buf, "x", split_axis=0, concat_axis=0,
                                    tiled=True)
        # NOTE capacity contract: the two appends consume
        # n_shards*route_cap + B_local*L_out RAW log slots per step
        # (tombstones included); callers must compact (sharded_compact)
        # often enough beforehand.
        rcv = routed.reshape(-1, store.key_words(k, b)).T
        rcv_valid = rcv[0] != _INVALID
        local = store.append(local, rcv,
                             jnp.ones(rcv.shape[1], dtype=U32), rcv_valid)
        # skew spill: rows beyond a destination's routing capacity stay on
        # the SOURCE shard (GROGRO analog, DenseMenuYo.hpp:216-240) — no
        # emission is ever dropped
        spilled = valid & ~routed_mask
        local = store.append(local, rows,
                             jnp.ones(rows.shape[1], dtype=U32), spilled)

        stats = ShardedStats(
            n_emitted=jax.lax.psum(jnp.sum(valid), "x"),
            n_routed=jax.lax.psum(jnp.sum(rcv_valid), "x"),
            n_spilled=jax.lax.psum(jnp.sum(spilled), "x"),
            n_boundaries=jax.lax.psum(
                jnp.sum(em.boundary & em.valid), "x"))
        return (local.keys[None], local.data[None], local.n_sorted[None],
                local.n_used[None], carry2, stats)

    specs_state = (P("x"), P("x"), P("x"), P("x"))
    out = jax.shard_map(
        step, mesh=mesh,
        in_specs=specs_state + (P("x"), P("x"), P("x"),
                                jax.tree.map(lambda _: P("x"), carry)),
        out_specs=specs_state + (jax.tree.map(lambda _: P("x"), carry),
                                 jax.tree.map(lambda _: P(), ShardedStats(
                                     0, 0, 0, 0))),
        check_vma=False,
    )(state.keys, state.data, state.n_sorted, state.n_used,
      codes, fresh, valid_end, carry)
    keys, data, ns, nu, carry2, stats = out
    return store.IndexState(keys, data, ns, nu), carry2, stats


@partial(jax.jit, static_argnames=("mesh",))
def sharded_compact(state: store.IndexState, mesh: Mesh
                    ) -> store.IndexState:
    """Per-shard compaction (sort + dedupe + segment-sum)."""
    def cmp(keys, data, ns, nu):
        local = store.compact(store.IndexState(keys[0], data[0], ns[0],
                                               nu[0]))
        return (local.keys[None], local.data[None], local.n_sorted[None],
                local.n_used[None])

    specs = (P("x"), P("x"), P("x"), P("x"))
    out = jax.shard_map(cmp, mesh=mesh, in_specs=specs, out_specs=specs,
                        check_vma=False)(
        state.keys, state.data, state.n_sorted, state.n_used)
    return store.IndexState(*out)


def _chain_exact_sharded(em, end, vs_i, chain, margin: int, n_shards: int):
    """Cross-shard version of pipeline._chain_exact: lanes are sharded
    contiguously over the mesh axis, so lane 0 of shard d continues the
    record of shard d-1's last lane. The equality certificate needs (a)
    the LEFT NEIGHBOR's last-lane end state (one all_gather of 7 scalars
    per shard) and (b) the prefix composition of the (u, q) recurrence
    over all earlier shards (all_gather of each shard's local composition
    + a static n_shards-long combine). All ICI-cheap: a few dozen scalars
    per step.

    chain is REPLICATED: (global last end state, exactness). Returns
    (exact (B_local,), new_chain)."""
    prev_end_g, prev_exact_g = chain
    d = jax.lax.axis_index("x")

    # left neighbor's last-lane end per field (shard 0 uses the carry)
    last_ends = [jax.lax.all_gather(e[-1], "x") for e in end]  # (n,) each
    is0 = d == 0

    def left(c, g):
        prev = g[jnp.maximum(d - 1, 0)]
        return jnp.where(is0, jnp.asarray(c).astype(prev.dtype), prev)

    lane0_pred = [left(c, g) for c, g in zip(prev_end_g, last_ends)]
    shift = lambda p0, e: jnp.concatenate(
        [p0[None].astype(e.dtype), e[:-1]])
    pred = [shift(p0, e) for p0, e in zip(lane0_pred, end)]
    eq = jnp.ones(vs_i.shape, dtype=bool)
    for a, bfield in zip(em.replay, pred):
        eq = eq & (a == bfield)
    u = em.cert
    q = eq & (vs_i != margin)

    def comb(a, bb):  # bb later
        return (bb[0] | (bb[1] & a[0]), bb[1] & a[1])

    U_loc, Q_loc = jax.lax.associative_scan(comb, (u, q))
    u_all = jax.lax.all_gather(U_loc[-1], "x")  # (n,) shard compositions
    q_all = jax.lax.all_gather(Q_loc[-1], "x")
    # exclusive prefix over shards < d (static loop, n_shards is small)
    u_pre = jnp.asarray(False)
    q_pre = jnp.asarray(True)
    for i in range(n_shards):
        u_c = u_all[i] | (q_all[i] & u_pre)
        q_c = q_all[i] & q_pre
        take = jnp.asarray(i) < d
        u_pre = jnp.where(take, u_c, u_pre)
        q_pre = jnp.where(take, q_c, q_pre)
    carry_in = u_pre | (q_pre & prev_exact_g)
    exact = U_loc | (Q_loc & carry_in)

    # replicated new chain: global composition + shard n-1's last end
    u_g = jnp.asarray(False)
    q_g = jnp.asarray(True)
    for i in range(n_shards):
        u_g, q_g = u_all[i] | (q_all[i] & u_g), q_all[i] & q_g
    exact_last = u_g | (q_g & prev_exact_g)
    end_last = MinimizerState(*(g[n_shards - 1] for g in last_ends))
    return exact, (end_last, exact_last)


@partial(jax.jit, static_argnames=("k", "m", "b", "mesh", "route_cap"),
         donate_argnums=(0,))
def sharded_insert_windows(state: store.IndexState, codes: jnp.ndarray,
                           valid_start: jnp.ndarray, valid_end: jnp.ndarray,
                           chain, k: int, m: int, b: int, mesh: Mesh,
                           route_cap: int):
    """Distributed insert of a stack of sequence-parallel WINDOW batches
    (io.windows) in ONE device program — the multi-chip analog of
    pipeline.insert_windows_sklnative's control flow on the packed store.

    Global shapes: codes (S, B, L_buf) with B = n_shards * B_local lanes
    data-parallel over the mesh; valid_start/valid_end (S, B). Each shard
    scans its own lanes, certifies them via the unique-min + cross-shard
    end-state equality chain (_chain_exact_sharded — this is what lets
    k > 32 records span every chip), routes certified emissions to their
    owner shard (bucket % n_shards) via all_to_all, and appends; overflow
    rows spill to the source shard (see module doc). `chain` is the
    REPLICATED continuity carry (pipeline.zero_chain() at stream start).

    Returns (state', n_superkmer_boundaries, n_kmers, n_spilled,
    cert (S, B) bool, ends MinimizerState of (S, B) leaves, chain').
    Uncertified lanes contribute nothing; callers repair them exactly via
    the streaming path and sharded_append_buf (see parallel.facade).

    Capacity contract (HOST-enforced): per shard and per step the two
    appends consume n_shards*route_cap + B_local*L_out raw log slots, so
    cap >= max_shard(n_used) + S*(n_shards*route_cap + B_local*L_out)
    before the call. Input state buffers are donated.
    """
    n_shards = mesh.shape["x"]
    W = store.key_words(k, b)
    margin = k - 1

    def run(st_keys, st_data, st_ns, st_nu, codes, vs, ve, ch):
        local = store.IndexState(st_keys[0], st_data[0], st_ns[0], st_nu[0])
        Bl = codes.shape[1]
        fresh = jnp.ones((Bl,), dtype=bool)
        zero = enum_ops.zero_carry(Bl)

        def step(carry, xs):
            st, ch = carry
            codes_i, vs_i, ve_i = xs
            em, end = enum_ops.enumerate_batch(
                codes_i, fresh, ve_i, zero, k=k, m=m, b=b, valid_start=vs_i)
            exact, ch = _chain_exact_sharded(em, end, vs_i, ch, margin,
                                             n_shards)
            rows = store.make_keys(em.bucket.reshape(-1),
                                   em.key.reshape(4, -1),
                                   em.mini_idx.reshape(-1), k, b)
            ok = (em.valid & exact[:, None]).reshape(-1)
            buf, routed_mask = _route_local(rows, em.bucket.reshape(-1),
                                            ok, n_shards, route_cap)
            routed = jax.lax.all_to_all(buf, "x", split_axis=0,
                                        concat_axis=0, tiled=True)
            rcv = routed.reshape(-1, W).T
            rcv_valid = rcv[0] != _INVALID
            st = store.append(st, rcv, jnp.ones(rcv.shape[1], dtype=U32),
                              rcv_valid)
            spilled = ok & ~routed_mask
            st = store.append(st, rows, jnp.ones(rows.shape[1], dtype=U32),
                              spilled)
            n_sk = jnp.sum(em.boundary & em.valid & exact[:, None]
                           ).astype(jnp.int32)
            return (st, ch), (n_sk, jnp.sum(ok).astype(jnp.int32),
                              jnp.sum(spilled).astype(jnp.int32), exact,
                              end)

        (local, ch), (n_sks, n_kms, n_sps, certs, ends) = jax.lax.scan(
            step, (local, ch), (codes, vs, ve))
        return (local.keys[None], local.data[None], local.n_sorted[None],
                local.n_used[None],
                jax.lax.psum(jnp.sum(n_sks), "x"),
                jax.lax.psum(jnp.sum(n_kms), "x"),
                jax.lax.psum(jnp.sum(n_sps), "x"),
                certs, ends, ch)

    specs_state = (P("x"), P("x"), P("x"), P("x"))
    lane = P(None, "x")
    chain_spec = jax.tree.map(lambda _: P(), chain)
    out = jax.shard_map(
        run, mesh=mesh,
        in_specs=specs_state + (lane, lane, lane, chain_spec),
        out_specs=specs_state + (P(), P(), P(), lane,
                                 jax.tree.map(lambda _: lane,
                                              enum_ops.zero_carry(1)),
                                 chain_spec),
        check_vma=False,
    )(state.keys, state.data, state.n_sorted, state.n_used,
      codes, valid_start, valid_end, chain)
    keys, data, ns, nu, n_sk, n_km, n_sp, certs, ends, chain2 = out
    return (store.IndexState(keys, data, ns, nu), n_sk, n_km, n_sp,
            certs, ends, chain2)


@partial(jax.jit, static_argnames=("k", "m", "b", "mesh", "row_cap",
                                   "skl_route_cap"),
         donate_argnums=(0,))
def sharded_insert_windows_sklonly(skl: sklstore.SklState,
                                   codes: jnp.ndarray,
                                   valid_start: jnp.ndarray,
                                   valid_end: jnp.ndarray,
                                   chain, k: int, m: int, b: int,
                                   mesh: Mesh, row_cap: int,
                                   skl_route_cap: int):
    """THE pod-scale insert program (round 5, VERDICT r4 item 3): the
    per-shard compacted super-k-mer arena is the ONLY index state — the
    16 B/kmer packed IndexState that sharded_insert_windows_skl
    double-wrote (~5x the arena's bytes/kmer, plus a second all_to_all
    and two more appends per step) is gone from the hot path, matching
    the single-chip product (api.py). Each shard scans its lanes,
    certifies them (unique-min + cross-shard end-state equality chain),
    segments emissions into skl rows, routes rows to their owner shard
    (bucket % n_shards) via all_to_all with skew overflow spilling to
    the source shard, and dense-appends live-first.

    Returns (skl', n_sk, n_km, n_spilled_rows, cert (S, B) bool, ends,
    skl_overflow (S, B), chain'). Capacity contract: per shard and per
    step the arena absorbs <= n_shards*skl_route_cap + B_local*row_cap
    rows."""
    n_shards = mesh.shape["x"]
    margin = k - 1
    nw = skl.nucs.shape[1]
    WR = 2 + nw  # row record: bucket | meta | nucs words

    def run(sk_bucket, sk_meta, sk_nucs, sk_data, sk_offs, sk_nr,
            sk_nfr, sk_nfk, codes, vs, ve, ch):
        lskl = sklstore.SklState(sk_bucket[0], sk_meta[0], sk_nucs[0],
                                 sk_data[0], sk_offs[0], sk_nr[0],
                                 sk_nfr[0], sk_nfk[0])
        Bl = codes.shape[1]
        fresh = jnp.ones((Bl,), dtype=bool)
        zero = enum_ops.zero_carry(Bl)
        L_buf = codes.shape[2]
        pos_out = jnp.arange(margin, L_buf, dtype=U32)[None, :]
        R = Bl * row_cap

        def step(carry, xs):
            sk, ch = carry
            codes_i, vs_i, ve_i = xs
            em, end = enum_ops.enumerate_batch(
                codes_i, fresh, ve_i, zero, k=k, m=m, b=b, valid_start=vs_i)
            exact, ch = _chain_exact_sharded(em, end, vs_i, ch, margin,
                                             n_shards)
            ok2 = em.valid & exact[:, None]
            first_valid = pos_out == vs_i[:, None].astype(U32)
            rb, rm, rn, ovf = sklstore.rows_from_emissions(
                em.key, em.bucket, em.mini_idx, em.use_rc, ok2,
                first_valid, em.boundary, k, m, b, row_cap)
            rowrec = jnp.concatenate(
                [rb.reshape(1, R), rm.reshape(1, R), rn.reshape(nw, R)])
            live = rowrec[0] != _INVALID
            buf2, routed2_mask = _route_local(rowrec, rowrec[0], live,
                                              n_shards, skl_route_cap)
            routed2 = jax.lax.all_to_all(buf2, "x", split_axis=0,
                                         concat_axis=0, tiled=True)
            rcv2 = routed2.reshape(-1, WR).T  # (WR, n_shards*cap2)
            spill_rows = tuple(
                jnp.where(live & ~routed2_mask, rowrec[i],
                          _INVALID if i == 0 else 0)
                for i in range(WR))
            allrec = tuple(jnp.concatenate([rcv2[i], spill_rows[i]])
                           for i in range(WR))
            n_all = allrec[0].shape[0]
            order = jnp.where(allrec[0] != _INVALID,
                              jnp.arange(n_all, dtype=U32), _INVALID)
            sorted_rows = jax.lax.sort((order,) + allrec, num_keys=1)
            n_live_rows = jnp.sum(sorted_rows[0] != _INVALID
                                  ).astype(jnp.int32)
            sk = sklstore.append_n(
                sk, sorted_rows[1], sorted_rows[2],
                jnp.stack(sorted_rows[3:3 + nw]), n_live_rows)
            n_sk = jnp.sum(em.boundary & ok2).astype(jnp.int32)
            n_sp = jnp.sum(live & ~routed2_mask).astype(jnp.int32)
            return (sk, ch), (n_sk, jnp.sum(ok2).astype(jnp.int32),
                              n_sp, exact, end, ovf)

        ((lskl, ch),
         (n_sks, n_kms, n_sps, certs, ends, ovfs)) = jax.lax.scan(
            step, (lskl, ch), (codes, vs, ve))
        return (lskl.bucket[None], lskl.meta[None], lskl.nucs[None],
                lskl.data[None], lskl.offs[None], lskl.n_rows[None],
                lskl.n_fin_rows[None], lskl.n_fin_kmers[None],
                jax.lax.psum(jnp.sum(n_sks), "x"),
                jax.lax.psum(jnp.sum(n_kms), "x"),
                jax.lax.psum(jnp.sum(n_sps), "x"),
                certs, ends, ovfs, ch)

    sx = P("x")
    specs_skl = (sx,) * 8
    lane = P(None, "x")
    chain_spec = jax.tree.map(lambda _: P(), chain)
    out = jax.shard_map(
        run, mesh=mesh,
        in_specs=specs_skl + (lane, lane, lane, chain_spec),
        out_specs=specs_skl
        + (P(), P(), P(), lane,
           jax.tree.map(lambda _: lane, enum_ops.zero_carry(1)),
           lane, chain_spec),
        check_vma=False,
    )(skl.bucket, skl.meta, skl.nucs, skl.data, skl.offs, skl.n_rows,
      skl.n_fin_rows, skl.n_fin_kmers, codes, valid_start, valid_end,
      chain)
    (kb, km_, kn, kd, ko, knr, knfr, knfk,
     n_sk, n_km, n_sp, certs, ends, ovfs, chain2) = out
    return (sklstore.SklState(kb, km_, kn, kd, ko, knr, knfr, knfk),
            n_sk, n_km, n_sp, certs, ends, ovfs, chain2)


@partial(jax.jit, static_argnames=("k", "m", "b", "mesh", "route_cap",
                                   "row_cap", "skl_route_cap"),
         donate_argnums=(0, 1))
def sharded_insert_windows_skl(state: store.IndexState,
                               skl: sklstore.SklState,
                               codes: jnp.ndarray,
                               valid_start: jnp.ndarray,
                               valid_end: jnp.ndarray,
                               chain, k: int, m: int, b: int, mesh: Mesh,
                               route_cap: int, row_cap: int,
                               skl_route_cap: int):
    """sharded_insert_windows + per-shard compacted super-k-mer arenas:
    each shard additionally segments its lanes' emissions into skl rows
    (sklstore.rows_from_emissions) and routes them to their owner shard
    (bucket % n_shards) through a second all_to_all; overflow rows spill
    to the source shard; received + spilled rows dense-append live-first
    (sklstore.append_n semantics) so per-shard arenas stay
    tombstone-free.

    Returns (state', skl', n_sk, n_km, n_spilled, cert, ends,
    skl_overflow (S, B), chain'). Extra capacity contract: per shard and
    per step the skl arena absorbs <= n_shards*skl_route_cap +
    B_local*row_cap rows."""
    n_shards = mesh.shape["x"]
    W = store.key_words(k, b)
    margin = k - 1
    nw = skl.nucs.shape[1]
    WR = 2 + nw  # row record: bucket | meta | nucs words

    def run(st_keys, st_data, st_ns, st_nu,
            sk_bucket, sk_meta, sk_nucs, sk_data, sk_offs, sk_nr,
            sk_nfr, sk_nfk, codes, vs, ve, ch):
        local = store.IndexState(st_keys[0], st_data[0], st_ns[0], st_nu[0])
        lskl = sklstore.SklState(sk_bucket[0], sk_meta[0], sk_nucs[0],
                                 sk_data[0], sk_offs[0], sk_nr[0],
                                 sk_nfr[0], sk_nfk[0])
        Bl = codes.shape[1]
        fresh = jnp.ones((Bl,), dtype=bool)
        zero = enum_ops.zero_carry(Bl)
        L_buf = codes.shape[2]
        pos_out = jnp.arange(margin, L_buf, dtype=U32)[None, :]
        R = Bl * row_cap

        def step(carry, xs):
            st, sk, ch = carry
            codes_i, vs_i, ve_i = xs
            em, end = enum_ops.enumerate_batch(
                codes_i, fresh, ve_i, zero, k=k, m=m, b=b, valid_start=vs_i)
            exact, ch = _chain_exact_sharded(em, end, vs_i, ch, margin,
                                             n_shards)
            ok2 = em.valid & exact[:, None]
            rows = store.make_keys(em.bucket.reshape(-1),
                                   em.key.reshape(4, -1),
                                   em.mini_idx.reshape(-1), k, b)
            ok = ok2.reshape(-1)
            buf, routed_mask = _route_local(rows, em.bucket.reshape(-1),
                                            ok, n_shards, route_cap)
            routed = jax.lax.all_to_all(buf, "x", split_axis=0,
                                        concat_axis=0, tiled=True)
            rcv = routed.reshape(-1, W).T
            rcv_valid = rcv[0] != _INVALID
            st = store.append(st, rcv, jnp.ones(rcv.shape[1], dtype=U32),
                              rcv_valid)
            spilled = ok & ~routed_mask
            st = store.append(st, rows, jnp.ones(rows.shape[1], dtype=U32),
                              spilled)

            # compacted super-k-mer rows -> owner shards
            first_valid = pos_out == vs_i[:, None].astype(U32)
            rb, rm, rn, ovf = sklstore.rows_from_emissions(
                em.key, em.bucket, em.mini_idx, em.use_rc, ok2,
                first_valid, em.boundary, k, m, b, row_cap)
            rowrec = jnp.concatenate(
                [rb.reshape(1, R), rm.reshape(1, R), rn.reshape(nw, R)])
            live = rowrec[0] != _INVALID
            buf2, routed2_mask = _route_local(rowrec, rowrec[0], live,
                                              n_shards, skl_route_cap)
            routed2 = jax.lax.all_to_all(buf2, "x", split_axis=0,
                                         concat_axis=0, tiled=True)
            rcv2 = routed2.reshape(-1, WR).T  # (WR, n_shards*cap2)
            spill_rows = tuple(
                jnp.where(live & ~routed2_mask, rowrec[i],
                          _INVALID if i == 0 else 0)
                for i in range(WR))
            allrec = tuple(jnp.concatenate([rcv2[i], spill_rows[i]])
                           for i in range(WR))
            n_all = allrec[0].shape[0]
            order = jnp.where(allrec[0] != _INVALID,
                              jnp.arange(n_all, dtype=U32), _INVALID)
            sorted_rows = jax.lax.sort((order,) + allrec, num_keys=1)
            n_live_rows = jnp.sum(sorted_rows[0] != _INVALID
                                  ).astype(jnp.int32)
            sk = sklstore.append_n(
                sk, sorted_rows[1], sorted_rows[2],
                jnp.stack(sorted_rows[3:3 + nw]), n_live_rows)

            n_sk = jnp.sum(em.boundary & ok2).astype(jnp.int32)
            return (st, sk, ch), (n_sk, jnp.sum(ok).astype(jnp.int32),
                                  jnp.sum(spilled).astype(jnp.int32),
                                  exact, end, ovf)

        ((local, lskl, ch),
         (n_sks, n_kms, n_sps, certs, ends, ovfs)) = jax.lax.scan(
            step, (local, lskl, ch), (codes, vs, ve))
        return (local.keys[None], local.data[None], local.n_sorted[None],
                local.n_used[None],
                lskl.bucket[None], lskl.meta[None], lskl.nucs[None],
                lskl.data[None], lskl.offs[None], lskl.n_rows[None],
                lskl.n_fin_rows[None], lskl.n_fin_kmers[None],
                jax.lax.psum(jnp.sum(n_sks), "x"),
                jax.lax.psum(jnp.sum(n_kms), "x"),
                jax.lax.psum(jnp.sum(n_sps), "x"),
                certs, ends, ovfs, ch)

    sx = P("x")
    specs_state = (sx, sx, sx, sx)
    specs_skl = (sx,) * 8
    lane = P(None, "x")
    chain_spec = jax.tree.map(lambda _: P(), chain)
    out = jax.shard_map(
        run, mesh=mesh,
        in_specs=specs_state + specs_skl + (lane, lane, lane, chain_spec),
        out_specs=specs_state + specs_skl
        + (P(), P(), P(), lane,
           jax.tree.map(lambda _: lane, enum_ops.zero_carry(1)),
           lane, chain_spec),
        check_vma=False,
    )(state.keys, state.data, state.n_sorted, state.n_used,
      skl.bucket, skl.meta, skl.nucs, skl.data, skl.offs, skl.n_rows,
      skl.n_fin_rows, skl.n_fin_kmers, codes, valid_start, valid_end,
      chain)
    (keys, data, ns, nu, kb, km_, kn, kd, ko, knr, knfr, knfk,
     n_sk, n_km, n_sp, certs, ends, ovfs, chain2) = out
    return (store.IndexState(keys, data, ns, nu),
            sklstore.SklState(kb, km_, kn, kd, ko, knr, knfr, knfk),
            n_sk, n_km, n_sp, certs, ends, ovfs, chain2)


@partial(jax.jit, static_argnames=("mesh",), donate_argnums=(0,))
def sharded_append_skl_rows(skl: sklstore.SklState, buf: jnp.ndarray,
                            mesh: Mesh) -> sklstore.SklState:
    """Append a HOST-built row buffer: buf (n_shards, cap_r, 2+nw)
    uint32, INVALID-bucket-padded; shard d dense-appends buf[d]'s live
    rows to its arena (repaired-window and overflow-lane deliveries)."""
    nw = skl.nucs.shape[1]

    def run(bucket, meta, nucs, data, offs, nr, nfr, nfk, buf):
        lskl = sklstore.SklState(bucket[0], meta[0], nucs[0], data[0],
                                 offs[0], nr[0], nfr[0], nfk[0])
        rec = buf[0].T  # (2+nw, cap_r)
        n = rec.shape[1]
        order = jnp.where(rec[0] != _INVALID, jnp.arange(n, dtype=U32),
                          _INVALID)
        srt = jax.lax.sort((order,) + tuple(rec[i] for i in
                                            range(rec.shape[0])),
                           num_keys=1)
        n_live = jnp.sum(srt[0] != _INVALID).astype(jnp.int32)
        lskl = sklstore.append_n(lskl, srt[1], srt[2],
                                 jnp.stack(srt[3:3 + nw]), n_live)
        return (lskl.bucket[None], lskl.meta[None], lskl.nucs[None],
                lskl.data[None], lskl.offs[None], lskl.n_rows[None],
                lskl.n_fin_rows[None], lskl.n_fin_kmers[None])

    sx = P("x")
    specs = (sx,) * 8
    out = jax.shard_map(run, mesh=mesh, in_specs=specs + (sx,),
                        out_specs=specs, check_vma=False)(
        skl.bucket, skl.meta, skl.nucs, skl.data, skl.offs, skl.n_rows,
        skl.n_fin_rows, skl.n_fin_kmers, buf)
    return sklstore.SklState(*out)


@partial(jax.jit, static_argnames=("mesh",), donate_argnums=(0,))
def sharded_append_buf(state: store.IndexState, buf: jnp.ndarray,
                       mesh: Mesh) -> store.IndexState:
    """Append a HOST-built routing buffer: buf (n_shards, cap_r, W) uint32,
    INVALID-padded; shard d appends buf[d] to its local log. Used by the
    facade to deliver repaired-window rows to their owner shards."""
    def run(keys, data, ns, nu, buf):
        local = store.IndexState(keys[0], data[0], ns[0], nu[0])
        rows = buf[0].reshape(-1, buf.shape[-1]).T
        valid = rows[0] != _INVALID
        local = store.append(local, rows,
                             jnp.ones(rows.shape[1], dtype=U32), valid)
        return (local.keys[None], local.data[None], local.n_sorted[None],
                local.n_used[None])

    specs = (P("x"), P("x"), P("x"), P("x"))
    out = jax.shard_map(run, mesh=mesh, in_specs=specs + (P("x"),),
                        out_specs=specs, check_vma=False)(
        state.keys, state.data, state.n_sorted, state.n_used, buf)
    return store.IndexState(*out)


@partial(jax.jit, static_argnames=("mesh",), donate_argnums=(0,))
def sharded_append_valued_buf(state: store.IndexState, buf: jnp.ndarray,
                              mesh: Mesh) -> store.IndexState:
    """sharded_append_buf with an extra trailing VALUE column per row
    (explicit counts instead of 1) — reallocate's re-keyed entries keep
    their accumulated totals."""
    def run(keys, data, ns, nu, buf):
        local = store.IndexState(keys[0], data[0], ns[0], nu[0])
        rec = buf[0].reshape(-1, buf.shape[-1]).T
        rows = rec[:-1]
        vals = rec[-1]
        valid = rows[0] != _INVALID
        local = store.append(local, rows, vals, valid)
        return (local.keys[None], local.data[None], local.n_sorted[None],
                local.n_used[None])

    specs = (P("x"), P("x"), P("x"), P("x"))
    out = jax.shard_map(run, mesh=mesh, in_specs=specs + (P("x"),),
                        out_specs=specs, check_vma=False)(
        state.keys, state.data, state.n_sorted, state.n_used, buf)
    return store.IndexState(*out)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_lookup(state: store.IndexState, keys: jnp.ndarray, mesh: Mesh
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Query (W, Q) packed keys against every shard's SORTED region and
    psum the results: found (Q,) int32 (#shards holding the key) and
    values (Q,) uint32 (total count). Summing across shards makes spill
    placement invisible to readers. Callers compact every shard first."""
    def run(st_keys, st_data, st_ns, st_nu, q):
        local = store.IndexState(st_keys[0], st_data[0], st_ns[0], st_nu[0])
        found, vals = store.lookup(local, q)
        return (jax.lax.psum(found.astype(jnp.int32), "x"),
                jax.lax.psum(jnp.where(found, vals, U32(0)), "x"))

    specs = (P("x"), P("x"), P("x"), P("x"))
    out = jax.shard_map(run, mesh=mesh, in_specs=specs + (P(),),
                        out_specs=(P(), P()), check_vma=False)(
        state.keys, state.data, state.n_sorted, state.n_used, keys)
    return out


def sharded_grow(state: store.IndexState, new_capacity: int, mesh: Mesh
                 ) -> store.IndexState:
    """Host-side per-shard capacity growth (pad the entry axis)."""
    cap = state.keys.shape[2]
    assert new_capacity > cap
    pad = new_capacity - cap
    sharding = NamedSharding(mesh, P("x"))
    return store.IndexState(
        keys=jax.device_put(
            jnp.pad(state.keys, ((0, 0), (0, 0), (0, pad)),
                    constant_values=np.uint32(0xFFFFFFFF)), sharding),
        data=jax.device_put(jnp.pad(state.data, ((0, 0), (0, pad))),
                            sharding),
        n_sorted=state.n_sorted, n_used=state.n_used)


def sharded_skl_empty(n_shards: int, row_cap: int, kmer_cap: int,
                      nw: int, mesh: Mesh) -> sklstore.SklState:
    """Per-shard compacted super-k-mer arenas with a leading shard axis
    (the facade's C8 storage at pod scale, VERDICT r2 item 5)."""
    sharding = NamedSharding(mesh, P("x"))

    def put(x):
        return jax.device_put(x, sharding)

    return sklstore.SklState(
        bucket=put(jnp.full((n_shards, row_cap), _INVALID, dtype=U32)),
        meta=put(jnp.zeros((n_shards, row_cap), dtype=U32)),
        nucs=put(jnp.zeros((n_shards, nw, row_cap), dtype=U32)),
        data=put(jnp.zeros((n_shards, kmer_cap), dtype=U32)),
        offs=put(jnp.zeros((n_shards, row_cap), dtype=U32)),
        n_rows=put(jnp.zeros((n_shards,), jnp.int32)),
        n_fin_rows=put(jnp.zeros((n_shards,), jnp.int32)),
        n_fin_kmers=put(jnp.zeros((n_shards,), jnp.int32)))


def sharded_skl_grow(skl: sklstore.SklState, row_cap: int, mesh: Mesh
                     ) -> sklstore.SklState:
    """Per-shard row-capacity growth (pad the row axis)."""
    pad = row_cap - skl.bucket.shape[1]
    assert pad >= 0
    sharding = NamedSharding(mesh, P("x"))

    def put(x):
        return jax.device_put(x, sharding)

    return skl._replace(
        bucket=put(jnp.pad(skl.bucket, ((0, 0), (0, pad)),
                           constant_values=np.uint32(0xFFFFFFFF))),
        meta=put(jnp.pad(skl.meta, ((0, 0), (0, pad)))),
        nucs=put(jnp.pad(skl.nucs, ((0, 0), (0, 0), (0, pad)))),
        offs=put(jnp.pad(skl.offs, ((0, 0), (0, pad)))))


def sharded_empty(n_shards: int, capacity: int, mesh: Mesh, nkey: int
                  ) -> store.IndexState:
    """Index state with a leading shard axis, placed sharded on the mesh."""
    sharding = NamedSharding(mesh, P("x"))
    return store.IndexState(
        keys=jax.device_put(
            jnp.full((n_shards, nkey, capacity), _INVALID, dtype=U32),
            sharding),
        data=jax.device_put(jnp.zeros((n_shards, capacity), dtype=U32),
                            sharding),
        n_sorted=jax.device_put(jnp.zeros((n_shards,), jnp.int32), sharding),
        n_used=jax.device_put(jnp.zeros((n_shards,), jnp.int32), sharding))
