"""ShardedBrisk — the multi-chip user facade (SURVEY §5.8, VERDICT r1 #5c).

The single-chip `api.Brisk` on a `jax.sharding.Mesh`: record lanes are
data-parallel across shards, the index is sharded by reduced minimizer
(bucket % n_shards), and emissions ride a capacity-bounded all_to_all to
their owner shard with skew overflow spilling to the source shard
(parallel.sharded). The reference's whole-machine analog is one process
of OpenMP threads + a mutexed bucket matrix (DenseMenuYo.hpp:110-118);
this facade is the pod-scale replacement the blueprint demands.

Insertion (k <= 32) uses the fused sequence-parallel window pipeline:
records are split into overlapping windows (io.windows) across ALL
global lanes, a stack of S window batches runs as one device program
(sharded.sharded_insert_windows_sklonly), and the rare uncertified windows
are re-run exactly through the streaming carry path on the host's default
device and delivered to their owner shards via a host-built routing
buffer (sharded.sharded_append_skl_rows). k > 32 runs the same windowed
path (exact via batched repairs; see the note at _insert_windowed).

Capacity contracts are HOST-enforced: appends consume a fixed number of
raw log slots per step, tracked host-side as an upper bound so the hot
loop never reads back n_used; compaction/growth happen only when the
bound approaches capacity.
"""

from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from brisk_tpu.index import pipeline, readout, store
from brisk_tpu.io import fasta, windows
from brisk_tpu.oracle import pyref
from brisk_tpu.ops import enumerate as enum_ops
from brisk_tpu.params import Parameters
from brisk_tpu.parallel import sharded

U32 = np.uint32
_INVALID = U32(0xFFFFFFFF)


class ShardedBrisk:
    """Dynamic k-mer -> count index sharded over a device mesh."""

    def __init__(self, params: Parameters, mesh=None, n_devices: int = None,
                 batch_per_shard: int = 64, window: int = 256,
                 stack: int = 4, route_cap: int = None,
                 skl_route_cap: int = None, capacity: int = 1 << 16):
        import brisk_tpu
        brisk_tpu.enable_persistent_cache()
        from brisk_tpu.parallel import multihost
        if mesh is None:
            if jax.process_count() > 1:
                mesh = multihost.global_mesh()
            else:
                mesh = sharded.make_mesh(n_devices or len(jax.devices()))
        self.mesh = mesh
        self.params = params
        self.n_shards = mesh.shape["x"]
        self.B_local = batch_per_shard
        self.B = self.n_shards * batch_per_shard
        # large (k - m) warm-ups bump small windows (see api.Brisk)
        wu = windows.default_warmup(params.k, params.m)
        self.window = max(window, -(-(wu + 48) // 16) * 16)
        self.stack = stack
        # route_cap sizing (VERDICT r3 item 4): the r3 default covered
        # the all-to-one worst case (batch_per_shard * window), moving an
        # n_shards-times oversized all_to_all buffer every flush whether
        # skew existed or not. Destinations are hashed minimizer buckets,
        # so per-step per-destination traffic is multinomial around
        # mean = B_local*window/n_shards with std ~ sqrt(mean); 4x mean
        # clears any multinomial p99 by orders of magnitude, and the rare
        # genuinely-skewed flush (poly-A runs -> one hot bucket) SPILLS
        # to the source shard, which is exact by construction
        # (tests/test_facade.py::test_facade_skewed_input_spills_without
        # _loss). Routing overhead on four H100s is measured by the
        # benchmark (ROADMAP S3, R4).
        self.route_cap = route_cap or max(
            64, 4 * batch_per_shard * self.window // self.n_shards)
        self.W = store.key_words(params.k, params.b)
        # multi-host: host-major lane blocks — each process packs ONLY its
        # own records into its own devices' lanes (VERDICT r2 item 3);
        # programs run in lockstep over the global mesh
        mesh_devs = list(np.asarray(mesh.devices).reshape(-1))
        self.n_proc = len({d.process_index for d in mesh_devs})
        self.multihost = self.n_proc > 1
        self.pid = jax.process_index()
        my = [i for i, d in enumerate(mesh_devs)
              if d.process_index == self.pid]
        assert my == list(range(my[0], my[0] + len(my))), \
            "mesh must be host-major (multihost.global_mesh)"
        self.my_shards = my
        self.lane_offset = my[0] * batch_per_shard
        self.my_lanes = len(my) * batch_per_shard
        # ONE index state per shard (round 5, VERDICT r4 item 3): the
        # per-shard compacted super-k-mer arena below is the ONLY
        # resident structure, exactly like the single-chip api.Brisk —
        # the 16 B/kmer packed IndexState this facade double-wrote
        # through round 4 is gone (serving probes/joins the arenas).
        self.n_emitted = 0      # GLOBAL fused-path emissions + MY repairs
        self.n_superkmers = 0
        self.n_spilled = 0
        self.n_repaired_windows = 0
        self.n_skl_overflows = 0
        # repair contributions are per-process (multihost stats() sums
        # them across processes; the fused parts are already global psums)
        self._repair_emitted = 0
        self._repair_superkmers = 0
        # per-shard compacted super-k-mer arenas (C8 at pod scale,
        # VERDICT r2 item 5); like api.Brisk they are consolidated lazily
        self.skl = None
        self._skl_dirty = False
        self._skl_rows_ub = 0   # upper bound on max-shard skl n_rows
        self._skl_segments = {}  # shard -> [(lo, hi)] bucket-grouped runs
        from brisk_tpu.index import sklstore
        self.skl_row_cap = max(16, self.window // 4)
        # same multinomial sizing as route_cap (skl rows route by the
        # same hashed bucket; spill-to-source covers the tail)
        self.skl_route_cap = skl_route_cap or max(
            16, 4 * batch_per_shard * self.skl_row_cap
            // self.n_shards)
        _, _, _, nw = sklstore.skl_dims(params.k, params.m, params.b)
        self._skl_nw = nw
        per_flush = stack * (self.n_shards * self.skl_route_cap
                             + batch_per_shard * self.skl_row_cap)
        rcap = 1 << max(12, (2 * per_flush - 1).bit_length())
        if self.multihost:
            from brisk_tpu.index import sklstore
            from brisk_tpu.parallel import multihost as mh

            def mk(shape, dt, fillval):
                return mh.make_global(
                    mesh, shape, dt,
                    lambda idx: np.full(
                        tuple(s.stop - s.start for s in idx),
                        fillval, dtype=dt))

            n = self.n_shards
            self.skl = sklstore.SklState(
                bucket=mk((n, rcap), np.uint32, 0xFFFFFFFF),
                meta=mk((n, rcap), np.uint32, 0),
                nucs=mk((n, nw, rcap), np.uint32, 0),
                data=mk((n, 1 << 12), np.uint32, 0),
                offs=mk((n, rcap), np.uint32, 0),
                n_rows=mk((n,), np.int32, 0),
                n_fin_rows=mk((n,), np.int32, 0),
                n_fin_kmers=mk((n,), np.int32, 0))
        else:
            self.skl = sharded.sharded_skl_empty(self.n_shards, rcap,
                                                 1 << 12, nw, mesh)

    # -- capacity (host-enforced; see sharded_insert contract) --------------

    def _ensure_skl_room(self, rows_per_shard: int) -> None:
        rcap = self.skl.bucket.shape[1]
        if self._skl_rows_ub + rows_per_shard <= rcap:
            return
        self._skl_rows_ub = int(jnp.max(self.skl.n_rows))
        target = rcap
        while self._skl_rows_ub + rows_per_shard > target:
            target *= 2
        if target != rcap:
            self.skl = sharded.sharded_skl_grow(self.skl, target,
                                                self.mesh)

    # -- insertion -----------------------------------------------------------

    def insert_file(self, path: str) -> None:
        records = self._records(path)
        if self.multihost:
            # every process reads the (shared-FS) file; round-robin record
            # ownership; each packs only its own lanes
            records = [r for i, r in enumerate(records)
                       if i % self.n_proc == self.pid]
        self._insert_windowed(iter(records) if isinstance(records, list)
                              else records)

    def insert_sequence(self, seq: str) -> None:
        if self.multihost and self.pid != 0:
            seq = ""  # single sequence is owned by process 0
        self._insert_windowed(iter([seq] if seq else []))

    def _records(self, path: str):
        from brisk_tpu import native
        chunks = native.parse_fasta_codes(path)
        if chunks is not None:
            return iter(chunks)
        return pyref.read_fasta_chunks(path)

    # fused window path (every k: the cross-shard equality chain certifies
    # k > 32 windows, sharded._chain_exact_sharded). NOTE: at k > 32 the
    # truncation quirk starves the chain (see api._insert_streaming,
    # which single-chip k > 32 routes around with exact streaming; the
    # pod-scale streaming-skl program is the round-5 counterpart) —
    # counts stay EXACT here via the batched repair path, at repair-time
    # cost on quirk-heavy inputs.
    def _insert_windowed(self, records) -> None:
        from brisk_tpu.parallel import multihost
        p = self.params
        # each process packs ITS lane block only (the whole batch on a
        # single host); flush counts are synchronized so the collective
        # programs run in lockstep across processes
        my_B = self.my_lanes if self.multihost else self.B
        packer = windows.WindowPacker(p.k, p.m, my_B, l_out=self.window)
        self._prev_tail = None
        self._chain = pipeline.zero_chain()
        if self.multihost:
            self._chain = multihost.replicate(self.mesh, self._chain)
        S, L_buf = self.stack, packer.l_buf

        def empty_batch():
            return windows.WinBatch(
                np.zeros((my_B, packer.l_buf4), np.uint8),
                np.zeros(my_B, np.int32), np.zeros(my_B, np.int32), 0, 0,
                np.full(my_B, -1, np.int64), np.zeros(my_B, np.int32),
                packer.l_buf)

        n_flushes_target = None
        if self.multihost:
            records = [r for r in records if len(r) >= p.k]
            n_win = 0
            for r in records:
                n_k = len(r) - packer.margin
                n_win += 1 if n_k <= packer.l_out else \
                    1 + -(-(n_k - packer.l_out) // packer.useful)
            my_flushes = -(-(-(-n_win // my_B)) // S) if n_win else 0
            n_flushes_target = multihost.process_max(my_flushes)
            records = iter(records)

        n_flushed = 0
        pending = []
        for bt in packer.pack(records):
            pending.append(bt)
            if len(pending) == S:
                self._flush_stack(packer, pending)
                n_flushed += 1
                pending = []
        if pending:
            while len(pending) < S:  # pad to the compiled stack shape
                pending.append(empty_batch())
            self._flush_stack(packer, pending)
            n_flushed += 1
        # lockstep padding: processes that ran out of data keep issuing
        # empty flushes until every process has flushed the same count
        while n_flushes_target is not None and n_flushed < n_flushes_target:
            self._flush_stack(packer, [empty_batch() for _ in range(S)])
            n_flushed += 1

    def _flush_stack(self, packer, batches) -> None:
        from brisk_tpu.parallel import multihost
        p = self.params
        S = len(batches)
        B = self.my_lanes if self.multihost else self.B
        codes = np.stack([bt.codes for bt in batches])
        vs = np.stack([bt.valid_start for bt in batches])
        ve = np.stack([bt.valid_end for bt in batches])
        if self.multihost:
            gshape = (S, self.B, packer.l_buf)
            g_codes = multihost.lane_sharded(self.mesh, gshape, codes, 1,
                                             self.lane_offset)
            g_vs = multihost.lane_sharded(self.mesh, gshape[:2], vs, 1,
                                          self.lane_offset)
            g_ve = multihost.lane_sharded(self.mesh, gshape[:2], ve, 1,
                                          self.lane_offset)
        else:
            g_codes = jnp.asarray(codes)
            g_vs = jnp.asarray(vs)
            g_ve = jnp.asarray(ve)
        self._ensure_skl_room(S * (self.n_shards * self.skl_route_cap
                                   + self.B_local * self.skl_row_cap))
        (self.skl, n_sk, n_km, n_sp, cert, ends, ovf,
         self._chain) = sharded.sharded_insert_windows_sklonly(
            self.skl, g_codes, g_vs, g_ve, self._chain,
            k=p.k, m=p.m, b=p.b, mesh=self.mesh,
            row_cap=self.skl_row_cap,
            skl_route_cap=self.skl_route_cap)
        self._skl_rows_ub += S * (self.n_shards * self.skl_route_cap
                                  + self.B_local * self.skl_row_cap)
        self._skl_dirty = True
        self.n_emitted += int(n_km)
        self.n_spilled += int(n_sp)
        self.n_superkmers += int(n_sk) + sum(bt.n_records for bt in batches)

        # exact repair of uncertified windows: consecutive failures form
        # contiguous genome runs, each re-run as ONE streaming lane;
        # independent runs batch across lanes (mirrors api._repair_runs).
        # Multi-host: each process repairs ITS lane block only (records
        # never span processes)
        if self.multihost:
            off, cert_l = multihost.lane_block(cert, 1)
            assert off == self.lane_offset
            cert_f = cert_l.reshape(-1)
            ends_f = [multihost.lane_block(x, 1)[1].reshape(S * B)
                      for x in ends]
        else:
            cert_f = np.asarray(cert).reshape(-1)
            ends_f = [np.asarray(x).reshape(S * B) for x in ends]
        rec_f = np.concatenate([bt.rec for bt in batches])
        win_f = np.concatenate([bt.win for bt in batches])
        failed = np.nonzero((~cert_f) & (rec_f >= 0))[0]
        repaired_ends = {}

        def end_of(j):
            if j in repaired_ends:
                return repaired_ends[j]
            return tuple(e[j] for e in ends_f)

        for j in failed:
            r, w = int(rec_f[j]), int(win_f[j])
            assert w > 0, "window 0 is always certified"
            if j == 0:
                assert self._prev_tail[:2] == (r, w - 1), \
                    "stack continuity broken"
            else:
                assert rec_f[j - 1] == r and win_f[j - 1] == w - 1
        MAX_RUN = 64
        runs = []
        for j in (int(x) for x in failed):
            if runs and runs[-1][-1] == j - 1 and len(runs[-1]) < MAX_RUN:
                runs[-1].append(j)
            else:
                runs.append([j])
        repaired_skl = []
        while runs:
            blocked = {j for rr in runs for j in rr}
            ready = [r for r in runs if r[0] - 1 not in blocked]
            rest = [r for r in runs if r[0] - 1 in blocked]
            carries = [self._prev_tail[2] if r[0] == 0 else end_of(r[0] - 1)
                       for r in ready]
            end7s, sklrows_np = self._rerun_runs(
                packer, batches, ready, carries)
            for r, e7 in zip(ready, end7s):
                repaired_ends[r[-1]] = e7
            if sklrows_np is not None:
                repaired_skl.append(sklrows_np)
            self.n_repaired_windows += sum(len(r) for r in ready)
            runs = rest

        live = np.nonzero(rec_f >= 0)[0]
        if len(live):
            j = int(live[-1])
            self._prev_tail = (int(rec_f[j]), int(win_f[j]), end_of(j))

        # skl-overflow lanes (certified, but > row_cap segments): rebuild
        # their rows at full width and deliver alongside repairs
        if ovf is not None:
            if self.multihost:
                _, ovf_l = multihost.lane_block(ovf, 1)
                ovf_f = ovf_l.reshape(-1)
            else:
                ovf_f = np.asarray(ovf).reshape(-1)
            ovf_lanes = np.nonzero(ovf_f & cert_f & (rec_f >= 0))[0]
            if len(ovf_lanes):
                repaired_skl.append(
                    self._rebuild_overflow_rows(packer, batches,
                                                ovf_lanes))
                self.n_skl_overflows += len(ovf_lanes)

        skl_all = (np.concatenate(repaired_skl, axis=0)
                   if repaired_skl else
                   np.zeros((0, 2 + self._skl_nw), dtype=U32))
        if self.multihost or len(skl_all):
            # collective delivery every flush on a multi-process mesh
            # (peers must call in lockstep even with zero local repairs)
            self._deliver_skl_rows(skl_all)

    def _rerun_runs(self, packer, batches, runs, carries):
        """Exact streaming re-run of runs of consecutive failed windows
        (one contiguous genome span per run, one lane per run, one device
        call per pass — see api.Brisk._repair_runs). Returns
        (end7 per run's LAST window, skl row records (N, 2+nw))."""
        p = self.params
        warmup, useful, l_buf = packer.warmup, packer.useful, packer.l_buf
        B = batches[0].codes.shape[0]  # local lane count
        R = len(runs)
        Rp = 1 << max(2, (R - 1).bit_length())
        span_max = 1 << (max(len(r) for r in runs) - 1).bit_length()  # shape family
        L_rep = (l_buf - warmup) + (span_max - 1) * useful
        codes = np.zeros((Rp, L_rep), dtype=np.uint8)
        ve = np.zeros(Rp, dtype=np.int32)
        carry_np = [np.zeros(Rp, dtype=np.asarray(c).dtype)
                    for c in enum_ops.zero_carry(1)]
        for i, (run, c7) in enumerate(zip(runs, carries)):
            s0, lane0 = divmod(run[0], B)
            pos = l_buf - warmup
            codes[i, :pos] = batches[s0].codes[lane0][warmup:]
            for j in run[1:]:
                s, lane = divmod(j, B)
                codes[i, pos:pos + useful] = \
                    batches[s].codes[lane][l_buf - useful:]
                pos += useful
            s_l, lane_l = divmod(run[-1], B)
            ve[i] = (len(run) - 1) * useful + \
                int(batches[s_l].valid_end[lane_l]) - warmup
            for f in range(7):
                carry_np[f][i] = c7[f]
        carry = enum_ops.MinimizerState(*(jnp.asarray(x)
                                          for x in carry_np))
        em, end = enum_ops.enumerate_batch(
            jnp.asarray(codes), jnp.zeros(Rp, bool), jnp.asarray(ve),
            carry, k=p.k, m=p.m, b=p.b)
        valid = np.asarray(em.valid).reshape(-1)
        sklrows_np = self._skl_rows_np(em, em.valid)
        self.n_emitted += int(valid.sum())
        self.n_superkmers += int(jnp.sum(em.boundary & em.valid))
        self._repair_emitted += int(valid.sum())
        self._repair_superkmers += int(jnp.sum(em.boundary & em.valid))
        margin = p.k - 1
        km = p.k - p.m
        dede = pyref.get_decycling(p.m)
        f_lo = np.asarray(em.mini_lo)
        f_hi = np.asarray(em.mini_hi)
        f_rc = np.asarray(em.use_rc)
        f_mi = np.asarray(em.mini_idx)
        f_hh = np.asarray(em.hash_hi)
        f_hl = np.asarray(em.hash_lo)
        end7s = []
        for i in range(R):
            idx = int(ve[i]) - margin - 1
            rev = bool(f_rc[i, idx])
            mi = int(f_mi[i, idx])
            pos_v = (km - mi) if rev else mi
            mini = (int(f_hi[i, idx]) << 32) | int(f_lo[i, idx])
            heavy = dede.mem_double(mini)
            end7s.append((np.uint32(f_lo[i, idx]), np.uint32(f_hi[i, idx]),
                          np.uint32(pos_v), np.bool_(rev),
                          np.uint32(heavy), np.uint32(f_hh[i, idx]),
                          np.uint32(f_hl[i, idx])))
        return end7s, sklrows_np

    def _skl_rows_np(self, em, valid) -> np.ndarray:
        """Full-width skl row assembly for repair/overflow emissions ->
        host (N, 2+nw) live row records (first emission per lane starts a
        segment; rows split at repair seams exactly as in api.Brisk)."""
        from brisk_tpu.index import sklstore
        p = self.params
        L_out = em.valid.shape[1]
        margin = p.k - 1
        pos = jnp.arange(margin, margin + L_out, dtype=jnp.uint32)[None, :]
        va = np.asarray(valid)
        first_valid = np.zeros_like(va)
        for lane in range(va.shape[0]):
            nz = np.nonzero(va[lane])[0]
            if len(nz):
                first_valid[lane, nz[0]] = True
        rb, rm, rn, ovf = sklstore.rows_from_emissions(
            em.key, em.bucket, em.mini_idx, em.use_rc, valid,
            jnp.asarray(first_valid), em.boundary, p.k, p.m, p.b, L_out)
        assert not bool(np.any(np.asarray(ovf)))
        rb_f = np.asarray(rb).reshape(-1)
        live = rb_f != _INVALID
        rm_f = np.asarray(rm).reshape(-1)[live]
        rn_f = np.asarray(rn).reshape(rn.shape[0], -1)[:, live]
        return np.concatenate([rb_f[live][None], rm_f[None], rn_f],
                              axis=0).T.astype(U32)

    def _rebuild_overflow_rows(self, packer, batches, lanes) -> np.ndarray:
        """Re-run certified skl-overflow lanes at full width (their
        k-mers were inserted by the fused program; only their rows were
        withheld). Windowed single batch, one device call."""
        p = self.params
        B = batches[0].codes.shape[0]
        R = len(lanes)
        Rp = 1 << max(2, (R - 1).bit_length())
        L_buf = packer.l_buf
        codes = np.zeros((Rp, L_buf), dtype=np.uint8)
        vs = np.zeros(Rp, dtype=np.int32)
        ve = np.zeros(Rp, dtype=np.int32)
        for i, j in enumerate(int(x) for x in lanes):
            s, lane = divmod(j, B)
            codes[i] = batches[s].codes[lane]
            vs[i] = int(batches[s].valid_start[lane])
            ve[i] = int(batches[s].valid_end[lane])
        em, _ = enum_ops.enumerate_batch(
            jnp.asarray(codes), jnp.ones(Rp, bool), jnp.asarray(ve),
            enum_ops.zero_carry(Rp), k=p.k, m=p.m, b=p.b,
            valid_start=jnp.asarray(vs))
        return self._skl_rows_np(em, em.valid)

    def _deliver_skl_rows(self, rows_np: np.ndarray) -> None:
        """Deliver host-built skl row records (N, 2+nw) to shards: routed
        by bucket ownership on a single host, spilled to this process's
        own shards on a multi-process mesh (collective; lockstep)."""
        from brisk_tpu.parallel import multihost
        WR = 2 + self._skl_nw
        if self.multihost:
            if multihost.process_max(len(rows_np)) == 0:
                return
            n_mine = len(self.my_shards)
            cap_r = multihost.process_max(
                -(-max(len(rows_np), 1) // n_mine))
            local = np.zeros((n_mine, cap_r, WR), dtype=U32)
            local[:, :, 0] = _INVALID
            for i in range(n_mine):
                rd = rows_np[i * cap_r:(i + 1) * cap_r]
                local[i, :len(rd)] = rd
            buf = multihost.lane_sharded(
                self.mesh, (self.n_shards, cap_r, WR), local, 0,
                self.my_shards[0])
        else:
            dest = rows_np[:, 0] % U32(self.n_shards)
            cap_r = max(int(np.bincount(dest,
                                        minlength=self.n_shards).max()), 1)
            host_buf = np.zeros((self.n_shards, cap_r, WR), dtype=U32)
            host_buf[:, :, 0] = _INVALID
            for d in range(self.n_shards):
                rd = rows_np[dest == d]
                host_buf[d, :len(rd)] = rd
            buf = jax.device_put(
                jnp.asarray(host_buf),
                jax.sharding.NamedSharding(self.mesh,
                                           jax.sharding.PartitionSpec("x")))
        self._ensure_skl_room(cap_r)
        self.skl = sharded.sharded_append_skl_rows(self.skl, buf,
                                                   self.mesh)
        self._skl_rows_ub += cap_r
        self._skl_dirty = True

    # -- lookup ----------------------------------------------------------------

    def get(self, kmer: str) -> Optional[int]:
        """Count of one k-mer (orientation-sensitive, like api.Brisk.get /
        Brisk::get, Brisk.hpp:63-69), summed across shards. Served from
        the per-shard arenas (round 5): every addressable shard's bucket
        slice is probed — spill placement (a key living off its owner
        shard) is invisible because counts sum across shards."""
        from brisk_tpu.index import keying, sklstore
        p = self.params
        if len(kmer) != p.k:
            raise ValueError(f"need a {p.k}-mer, got {len(kmer)} bases")
        self.finalize()
        buckets, cols = keying.key_batch(
            keying.strs_to_codes([kmer]), p.m, p.b)
        bucket = int(buckets[0])
        total = 0
        found_any = False
        for d, lskl in self._local_skl():
            found, vals = sklstore.probe(
                lskl, cols, bucket, p.k, p.m, p.b,
                segments=self._skl_segments.get(d))
            if bool(found[0]):
                found_any = True
                total += int(vals[0])
        if self.multihost:
            from brisk_tpu.parallel import multihost
            total = multihost.process_sum(total)
            found_any = multihost.process_sum(int(found_any)) > 0
        if found_any:
            return total % 256
        return None

    def get_canonical(self, kmer: str) -> Optional[int]:
        c = self.get(kmer)
        if c is not None:
            return c
        p = self.params
        rc = pyref.num2str(pyref.revcomp(pyref.str2num(kmer), p.k), p.k)
        return self.get(rc)

    def query_file(self, path: str) -> int:
        """Sum of stored counts over every k-mer emission of a query FASTA
        (reference query_fasta, counter.cpp:314-346): the query file is
        enumerated straight to packed keys and joined against each
        addressable shard's arena expansion (sort-merge; no shadow index,
        no per-batch gather lookups). Each stored slot lives on exactly
        one shard, so per-shard totals sum exactly — spill placement is
        invisible."""
        from brisk_tpu.index import sklstore
        p = self.params
        self.finalize()
        qk_parts, qlive_parts = [], []
        carry = enum_ops.zero_carry(self.B)
        for bt in fasta.fasta_batches(path, p.k, self.B, self.window):
            em, carry = enum_ops.enumerate_batch(
                jnp.asarray(bt.codes, dtype=jnp.uint32),
                jnp.asarray(bt.fresh), jnp.asarray(bt.valid_end),
                carry, k=p.k, m=p.m, b=p.b)
            rows = store.make_keys(em.bucket.reshape(-1),
                                   em.key.reshape(4, -1),
                                   em.mini_idx.reshape(-1), p.k, p.b)
            qk_parts.append(np.asarray(rows))
            qlive_parts.append(np.asarray(em.valid).reshape(-1))
        if not qk_parts:
            return 0
        qk = np.concatenate(qk_parts, axis=1)
        qlive = np.concatenate(qlive_parts).astype(np.uint32)
        total = 0
        for d, lskl in self._local_skl():
            total += sklstore.query_join_keys_total(lskl, qk, qlive,
                                                    p.k, p.m, p.b)
        if self.multihost:
            from brisk_tpu.parallel import multihost
            total = multihost.process_sum(total)
        # the join sums mod-256 per emission; callers see the same wrap
        return total

    # -- enumeration / stats -----------------------------------------------

    def items(self) -> Iterator[Tuple[int, int]]:
        """(kmer_value, count mod 256) per stored entry, shard by shard
        (per-shard TRANSIENT expansion of the arena, like api.Brisk). A
        key split between its owner and spill shards appears once per
        holding shard; counts_dict() aggregates. On a multi-process mesh
        each process yields ITS shards only (a pod-wide export
        concatenates per-process outputs, tests/multihost_worker.py)."""
        from brisk_tpu.index import sklstore
        self.finalize()
        params = self.params
        for d, lskl in self._local_skl():
            view = sklstore.expanded_state(lskl, params.k, params.m,
                                           params.b)
            kmers, counts, _ = readout.entries(view, params)
            for kv, c in zip(kmers, counts):
                yield int(kv), int(c) % 256

    def counts_dict(self) -> dict:
        agg = {}
        for kv, c in self.items():
            agg[kv] = (agg.get(kv, 0) + c) % 256
        return agg

    def stats(self) -> dict:
        from brisk_tpu.index import sklstore
        from brisk_tpu.parallel import multihost
        self.finalize()
        shard_entries = {}
        n_live_local = 0
        arena_bytes_local = 0
        p = self.params
        for d, lskl in self._local_skl():
            s = sklstore.stats(lskl, p.k, p.m, p.b)
            shard_entries[d] = s["nb_superkmer_rows"]
            n_live_local += s["nb_live_kmers"]
            arena_bytes_local += s["resident_bytes"]
        n_live = multihost.process_sum(n_live_local)
        arena_bytes = multihost.process_sum(arena_bytes_local)
        nb_superkmers = self.n_superkmers
        nb_emitted = self.n_emitted
        if self.multihost:
            # fused parts are global psums (identical everywhere); repair
            # parts are per-process and must be summed
            nb_superkmers = (nb_superkmers - self._repair_superkmers
                             + multihost.process_sum(
                                 self._repair_superkmers))
            nb_emitted = (nb_emitted - self._repair_emitted
                          + multihost.process_sum(self._repair_emitted))
        return dict(n_shards=self.n_shards, nb_kmers=n_live,
                    nb_superkmers=nb_superkmers,
                    nb_emitted=nb_emitted,
                    n_spilled=self.n_spilled,
                    n_repaired_windows=self.n_repaired_windows,
                    shard_entries=shard_entries,
                    index_bytes=arena_bytes,
                    bytes_per_kmer=(arena_bytes / n_live) if n_live
                    else 0.0)

    # -- compacted super-k-mer arena (C8 at pod scale) -----------------------

    def _local_skl(self):
        """(shard_id, single-shard SklState) per addressable shard, each
        on its own device: per-shard programs (finalize, probes, joins)
        then run on the shard's card alone. (Indexing the global array,
        skl.bucket[d], would give a copy replicated over the whole mesh
        and compile every per-shard program for all devices.)"""
        from brisk_tpu.index import sklstore
        fields = {}
        for name in sklstore.SklState._fields:
            for s in getattr(self.skl, name).addressable_shards:
                fields.setdefault(s.index[0].start or 0, {})[name] = \
                    s.data[0]
        for d in sorted(fields):
            yield d, sklstore.SklState(**fields[d])

    def finalize(self) -> None:
        """Consolidate every shard's super-k-mer arena (duplicate k-mer
        counts merged, dead rows dropped, rows grouped by bucket) —
        per-shard sklstore.finalize_device, then reassembly of the
        shard-axis arrays."""
        if self.skl is None or not self._skl_dirty:
            return
        from brisk_tpu.index import sklstore
        from brisk_tpu.parallel import multihost as mh
        p = self.params
        done = {}
        kcap_max = rcap_max = 1
        for d, lskl in self._local_skl():
            f_before = int(lskl.n_fin_rows)
            fin = sklstore.finalize_device(lskl, p.k, p.m, p.b)
            done[d] = fin
            f_after = int(fin.n_fin_rows)
            segs = self._skl_segments.get(d, [])
            if f_after == 0:
                segs = []
            elif f_before == 0:
                segs = [(0, f_after)]  # fused fresh finalize: one run
            elif f_after > f_before:
                segs = segs + [(f_before, f_after)]
            self._skl_segments[d] = segs
            kcap_max = max(kcap_max, fin.data.shape[0])
            rcap_max = max(rcap_max, fin.bucket.shape[0])
        kcap = mh.process_max(kcap_max)
        rcap = mh.process_max(rcap_max)
        for d, fin in done.items():
            pad_k = kcap - fin.data.shape[0]
            pad_r = rcap - fin.bucket.shape[0]
            done[d] = fin._replace(
                data=jnp.pad(fin.data, (0, pad_k)),
                bucket=jnp.pad(fin.bucket, (0, pad_r),
                               constant_values=np.uint32(0xFFFFFFFF)),
                meta=jnp.pad(fin.meta, (0, pad_r)),
                nucs=jnp.pad(fin.nucs, ((0, 0), (0, pad_r))),
                offs=jnp.pad(fin.offs, (0, pad_r)))
        n = self.n_shards
        nw = self._skl_nw

        def assemble(name, shape_tail, dt):
            def fill(idx):
                sl = idx[0]
                d = sl.start
                val = getattr(done[d], name)
                out = np.asarray(val)
                return out[None]

            return mh.make_global(self.mesh, (n,) + shape_tail, dt, fill)

        self.skl = sklstore.SklState(
            bucket=assemble("bucket", (rcap,), np.uint32),
            meta=assemble("meta", (rcap,), np.uint32),
            nucs=assemble("nucs", (nw, rcap), np.uint32),
            data=assemble("data", (kcap,), np.uint32),
            offs=assemble("offs", (rcap,), np.uint32),
            n_rows=assemble("n_rows", (), np.int32),
            n_fin_rows=assemble("n_fin_rows", (), np.int32),
            n_fin_kmers=assemble("n_fin_kmers", (), np.int32))
        self._skl_rows_ub = int(jnp.max(self.skl.n_rows)) \
            if not self.multihost else mh.process_max(
                max((int(f.n_rows) for f in done.values()), default=0))
        self._skl_dirty = False

    def skl_stats(self) -> Optional[dict]:
        if self.skl is None:
            return None
        from brisk_tpu.index import sklstore
        from brisk_tpu.parallel import multihost as mh
        p = self.params
        self.finalize()
        agg = dict(nb_superkmer_rows=0, nb_slots=0, nb_live_kmers=0,
                   resident_bytes=0)
        for d, lskl in self._local_skl():
            s = sklstore.stats(lskl, p.k, p.m, p.b)
            for key in agg:
                agg[key] += s[key]
        for key in list(agg):
            agg[key] = mh.process_sum(agg[key])
        agg["avg_kmers_per_skl"] = (agg["nb_slots"]
                                    / max(agg["nb_superkmer_rows"], 1))
        agg["bytes_per_kmer"] = (agg["resident_bytes"]
                                 / max(agg["nb_live_kmers"], 1))
        return agg

    def write_kff(self, path: str) -> None:
        """KFF export of the whole sharded index: per-shard super-k-mer
        sections concatenated into one file (each process writes
        `{path}.proc{pid}` on a multi-process mesh)."""
        from brisk_tpu.io import kff
        self.finalize()
        states = [lskl for _, lskl in self._local_skl()]
        out = f"{path}.proc{self.pid}" if self.multihost else path
        kff.write_index_skl_many(out, states, self.params)

    def reallocate(self) -> None:
        """Grow minimizer/bucket space (m += 2, b += 2, clamped at b=15)
        and re-key every stored entry under the new minimizer
        decomposition (reference Brisk::reallocate, Brisk.hpp:202-224;
        stop-the-world there too). Entries stay SHARD-LOCAL: the new
        bucket ids change hash ownership, but ownership is a routing
        heuristic — probes/joins sum across shards (spill semantics), so
        locality-only re-keying is exact on any mesh."""
        from brisk_tpu.index import rekey, sklstore
        self.finalize()
        old = self.params
        new_params = Parameters(k=old.k, m=old.m + 2, b=min(old.b + 2, 15))
        done = {}
        for d, lskl in self._local_skl():
            view = sklstore.expanded_state(lskl, old.k, old.m, old.b)
            new_state = rekey.reindex(view, old, new_params)
            done[d] = sklstore.from_entries(new_state, new_params.k,
                                            new_params.m, new_params.b)
        self.params = new_params
        self.W = store.key_words(new_params.k, new_params.b)
        self._skl_nw = sklstore.skl_dims(new_params.k, new_params.m,
                                         new_params.b)[3]
        self._assemble_skl(done)
        self._skl_dirty = False

    def _assemble_skl(self, done) -> None:
        """Pad per-shard arenas to the process-max caps and reassemble
        the shard-axis SklState pytree; resets the per-shard segment
        lists (each assembled arena is fully finalized = one
        bucket-grouped run)."""
        from brisk_tpu.index import sklstore
        from brisk_tpu.parallel import multihost as mh
        rcap = mh.process_max(max((f.bucket.shape[0]
                                   for f in done.values()), default=1))
        kcap = mh.process_max(max((f.data.shape[0]
                                   for f in done.values()), default=1))
        for d, fin in done.items():
            done[d] = fin._replace(
                bucket=jnp.pad(fin.bucket,
                               (0, rcap - fin.bucket.shape[0]),
                               constant_values=np.uint32(0xFFFFFFFF)),
                meta=jnp.pad(fin.meta, (0, rcap - fin.meta.shape[0])),
                nucs=jnp.pad(fin.nucs,
                             ((0, 0), (0, rcap - fin.nucs.shape[1]))),
                data=jnp.pad(fin.data, (0, kcap - fin.data.shape[0])),
                offs=jnp.pad(fin.offs, (0, rcap - fin.offs.shape[0])))
            self._skl_segments[d] = (
                [(0, int(fin.n_fin_rows))] if int(fin.n_fin_rows)
                else [])
        nw = self._skl_nw

        def assemble(name, shape_tail, dt):
            def fill(idx):
                d = idx[0].start
                return np.asarray(getattr(done[d], name))[None]

            return mh.make_global(self.mesh,
                                  (self.n_shards,) + shape_tail, dt,
                                  fill)

        self.skl = sklstore.SklState(
            bucket=assemble("bucket", (rcap,), np.uint32),
            meta=assemble("meta", (rcap,), np.uint32),
            nucs=assemble("nucs", (nw, rcap), np.uint32),
            data=assemble("data", (kcap,), np.uint32),
            offs=assemble("offs", (rcap,), np.uint32),
            n_rows=assemble("n_rows", (), np.int32),
            n_fin_rows=assemble("n_fin_rows", (), np.int32),
            n_fin_kmers=assemble("n_fin_kmers", (), np.int32))
        self._skl_rows_ub = mh.process_max(
            max((int(f.n_rows) for f in done.values()), default=0))

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Sharded checkpoint: per-shard arena arrays with the shard axis
        kept, so load() re-places them on any mesh of the same shard
        count.

        Multi-host: each process writes ONLY its shards to
        `{path}.proc{pid}.npz` (no host ever holds the whole index);
        load() on a single host reassembles all process files."""
        self.finalize()
        if self.multihost:
            shards = {}
            for d, lskl in self._local_skl():
                for name in lskl._fields:
                    shards[f"shard{d}_skl_{name}"] = \
                        np.asarray(getattr(lskl, name))
            np.savez_compressed(
                f"{path}.proc{self.pid}",
                shard_ids=np.asarray(self.my_shards),
                n_shards=self.n_shards, n_proc=self.n_proc,
                k=self.params.k, m=self.params.m, b=self.params.b,
                n_emitted=self.n_emitted, n_superkmers=self.n_superkmers,
                n_spilled=self.n_spilled, **shards)
            return
        extra = {f"skl_{name}": np.asarray(getattr(self.skl, name))
                 for name in self.skl._fields}
        np.savez_compressed(
            path,
            k=self.params.k, m=self.params.m, b=self.params.b,
            n_emitted=self.n_emitted, n_superkmers=self.n_superkmers,
            n_spilled=self.n_spilled, **extra)

    @classmethod
    def load_multihost_checkpoint(cls, path: str, mesh=None, **kw
                                  ) -> "ShardedBrisk":
        """Reassemble a multi-process checkpoint (`{path}.proc*.npz`) on
        a single host with enough devices."""
        import glob

        from brisk_tpu.index import sklstore
        files = sorted(glob.glob(f"{path}.proc*.npz"))
        assert files, f"no {path}.proc*.npz checkpoints found"
        parts = [np.load(f) for f in files]
        n_shards = int(parts[0]["n_shards"])
        params = Parameters(k=int(parts[0]["k"]), m=int(parts[0]["m"]),
                            b=int(parts[0]["b"]))
        if "shard0_skl_bucket" not in parts[0]:
            raise ValueError("not a super-k-mer-arena checkpoint (the "
                             "packed per-k-mer format was removed; "
                             "re-export via KFF)")
        if mesh is None:
            mesh = sharded.make_mesh(n_shards)
        self = cls(params, mesh=mesh, **kw)
        done = {}
        for z in parts:
            for d in (int(x) for x in z["shard_ids"]):
                done[d] = sklstore.SklState(
                    **{name: jnp.asarray(z[f"shard{d}_skl_{name}"])
                       for name in sklstore.SklState._fields})
        self._assemble_skl(done)
        self._skl_dirty = False
        self.n_emitted = int(parts[0]["n_emitted"])
        self.n_superkmers = int(parts[0]["n_superkmers"])
        self.n_spilled = sum(int(z["n_spilled"]) for z in parts)
        return self

    @classmethod
    def load(cls, path: str, mesh=None, **kw) -> "ShardedBrisk":
        from brisk_tpu.index import sklstore
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        params = Parameters(k=int(z["k"]), m=int(z["m"]), b=int(z["b"]))
        if "skl_bucket" not in z:
            raise ValueError("not a super-k-mer-arena checkpoint (the "
                             "packed per-k-mer format was removed; "
                             "re-export via KFF)")
        n_shards = z["skl_bucket"].shape[0]
        if mesh is None:
            mesh = sharded.make_mesh(n_shards)
        assert mesh.shape["x"] == n_shards, \
            f"checkpoint has {n_shards} shards, mesh has {mesh.shape['x']}"
        self = cls(params, mesh=mesh, **kw)
        sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x"))
        self.skl = sklstore.SklState(
            **{name: jax.device_put(jnp.asarray(z[f"skl_{name}"]), sh)
               for name in sklstore.SklState._fields})
        self._skl_rows_ub = int(jnp.max(self.skl.n_rows))
        self._skl_dirty = False
        nfr = np.asarray(z["skl_n_fin_rows"])
        self._skl_segments = {d: ([(0, int(nfr[d]))] if int(nfr[d])
                                  else []) for d in range(n_shards)}
        self.n_emitted = int(z["n_emitted"])
        self.n_superkmers = int(z["n_superkmers"])
        self.n_spilled = int(z["n_spilled"])
        return self
