"""BriskData — user-facing generic-payload index (`Brisk<DATA>`,
reference Brisk.hpp:23-42).

Each k-mer carries `width` uint32 payload lanes merged under static
per-lane kinds (index.payload). The counter is the width-1, ("sum",)
special case (api.Brisk keeps its own leaner store). The canonical
width-2 instantiation is count + last-position: kinds ("sum", "max")
with ascending positions.

The reference's update model is get() -> mutate DATA* under
protect/unprotect locks (Brisk.hpp:63-97); the functional array analog is
batched upsert: update() appends (key, payload) rows and the next
compaction merges them under the lane kinds — lock-free, one device
program per batch.
"""

from typing import Iterator, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from brisk_tpu.index import payload, pipeline, readout, store
from brisk_tpu.io import fasta, windows
from brisk_tpu.oracle import pyref
from brisk_tpu.ops import enumerate as enum_ops
from brisk_tpu.params import Parameters

U32 = np.uint32


class BriskData:
    """Dynamic k-mer -> (D uint32 lanes) index with batched
    insert/get/update and merge-on-compact semantics.

    insert_file runs the SAME fused sequence-parallel window pipeline as
    the counter (pipeline.insert_windows_payload): full-batch lanes,
    window-continuity chain, batched repairs. File-path payload lanes
    default to (count, record position) — the canonical `Brisk<DATA>`
    instantiation; insert_sequence additionally accepts arbitrary
    per-position extras."""

    def __init__(self, params: Parameters, width: int = 2,
                 kinds: Tuple[str, ...] = None, batch: int = 512,
                 window: int = 256, capacity: int = 1 << 14,
                 stack: int = 4):
        if kinds is None:
            kinds = ("sum",) + ("max",) * (width - 1)
        assert len(kinds) == width
        assert kinds[0] == "sum", \
            "lane 0 is the count lane (nonzero = live entry)"
        self.params = params
        self.width = width
        self.kinds = tuple(kinds)
        self.batch = batch
        wu = windows.default_warmup(params.k, params.m)
        self.window = max(window, -(-(wu + 48) // 16) * 16)
        self.stack = stack
        self.W = store.key_words(params.k, params.b)
        self.state = payload.empty(capacity, self.W, width)
        self.n_emitted = 0
        self.n_repaired_windows = 0
        self._dirty = False

    # -- insertion -----------------------------------------------------------

    def insert_file(self, path: str) -> None:
        """Windowed batched insertion of a FASTA; payload = (count,
        position-within-record) under the instance's lane kinds."""
        from brisk_tpu import native
        chunks = native.parse_fasta_codes(path)
        records = iter(chunks) if chunks is not None else \
            pyref.read_fasta_chunks(path)
        self._insert_windowed(records)

    def insert_sequence(self, seq: str, extra: np.ndarray = None) -> None:
        """Insert every k-mer of `seq`. Payload lane 0 gets +1 (count);
        lanes 1.. take `extra` ((width-1, n_kmers) uint32, indexed by
        k-mer start position). Default extra: the start position itself
        on every lane — with the default ("sum", "max") kinds that is
        count + LAST occurrence position."""
        p = self.params
        n_k = len(seq) - p.k + 1
        if n_k <= 0:
            return
        if extra is None:
            self._insert_windowed(iter([seq]))
            return
        assert extra.shape == (self.width - 1, n_k)

        packer = fasta.BatchPacker(p.k, 1, self.window)
        carry = enum_ops.zero_carry(1)
        offset = 0
        for bt in packer.pack(iter([seq])):
            em, carry = enum_ops.enumerate_batch(
                jnp.asarray(bt.codes, dtype=jnp.uint32),
                jnp.asarray(bt.fresh), jnp.asarray(bt.valid_end), carry,
                k=p.k, m=p.m, b=p.b)
            rows = store.make_keys(em.bucket.reshape(-1),
                                   em.key.reshape(4, -1),
                                   em.mini_idx.reshape(-1), p.k, p.b)
            valid = em.valid.reshape(-1)
            L_out = int(em.valid.shape[1])
            vals = np.zeros((self.width, L_out), dtype=U32)
            take = min(L_out, n_k - offset)
            vals[0, :take] = 1
            vals[1:, :take] = extra[:, offset:offset + take]
            offset += take
            self.state = payload.ensure_room(self.state, L_out)
            self.state = payload.append(self.state, rows,
                                        jnp.asarray(vals), valid)
            self.n_emitted += bt.n_kmers
        self._dirty = True

    # fused window path (mirrors api.Brisk._insert_windowed)
    def _insert_windowed(self, records) -> None:
        p = self.params
        packer = windows.WindowPacker(p.k, p.m, self.batch,
                                      l_out=self.window)
        self._prev_tail = None
        self._chain = pipeline.zero_chain()
        S, B, L_buf = self.stack, self.batch, packer.l_buf
        pending = []
        for bt in packer.pack(records):
            pending.append(bt)
            if len(pending) == S:
                self._flush(packer, pending)
                pending = []
        if pending:
            while len(pending) < S:
                pending.append(windows.WinBatch(
                    np.zeros((B, packer.l_buf4), np.uint8),
                    np.zeros(B, np.int32), np.zeros(B, np.int32), 0, 0,
                    np.full(B, -1, np.int64), np.zeros(B, np.int32),
                    packer.l_buf))
            self._flush(packer, pending)
        self._dirty = True

    def _flush(self, packer, batches) -> None:
        p = self.params
        S, B = len(batches), self.batch
        codes = np.stack([bt.codes for bt in batches])
        vs = np.stack([bt.valid_start for bt in batches])
        ve = np.stack([bt.valid_end for bt in batches])
        pos0 = np.stack([bt.win * packer.useful for bt in batches]
                        ).astype(U32)
        raw = S * B * packer.l_out
        cap = self.state.keys.shape[1]
        if int(self.state.n_used) + raw > cap:
            self.compact()
        self.state = payload.ensure_room(self.state, raw)
        (self.state, n_km, cert, ends,
         self._chain) = pipeline.insert_windows_payload(
            self.state, jnp.asarray(codes), jnp.asarray(vs),
            jnp.asarray(ve), jnp.asarray(pos0), self._chain,
            k=p.k, m=p.m, b=p.b, width=self.width)
        self.n_emitted += int(n_km)

        cert_f = np.asarray(cert).reshape(-1)
        rec_f = np.concatenate([bt.rec for bt in batches])
        win_f = np.concatenate([bt.win for bt in batches])
        ends_f = [np.asarray(x).reshape(S * B) for x in ends]
        failed = [int(j) for j in
                  np.nonzero((~cert_f) & (rec_f >= 0))[0]]
        repaired_ends = {}

        def end_of(j):
            if j in repaired_ends:
                return repaired_ends[j]
            return tuple(e[j] for e in ends_f)

        # repair failure runs as contiguous streaming spans (one lane per
        # run, batched across runs — same scheme as api.Brisk)
        MAX_RUN = 64
        runs = []
        for j in failed:
            if runs and runs[-1][-1] == j - 1 and len(runs[-1]) < MAX_RUN:
                runs[-1].append(j)
            else:
                runs.append([j])
        while runs:
            blocked = {j for rr in runs for j in rr}
            ready = [r for r in runs if r[0] - 1 not in blocked]
            rest = [r for r in runs if r[0] - 1 in blocked]
            carries = [self._prev_tail[2] if r[0] == 0 else end_of(r[0] - 1)
                       for r in ready]
            end7s = self._repair_runs(packer, batches, ready, carries)
            for r, e7 in zip(ready, end7s):
                repaired_ends[r[-1]] = e7
            self.n_repaired_windows += sum(len(r) for r in ready)
            runs = rest

        live = np.nonzero(rec_f >= 0)[0]
        if len(live):
            j = int(live[-1])
            self._prev_tail = (int(rec_f[j]), int(win_f[j]), end_of(j))

    def _repair_runs(self, packer, batches, runs, carries):
        """Streaming exact re-run of consecutive-failure runs with the
        (count, position) payload (cf. api.Brisk._repair_runs)."""
        p = self.params
        warmup, useful, l_buf = packer.warmup, packer.useful, packer.l_buf
        B = self.batch
        R = len(runs)
        Rp = 1 << max(2, (R - 1).bit_length())
        span_max = 1 << (max(len(r) for r in runs) - 1).bit_length()  # shape family
        L_rep = (l_buf - warmup) + (span_max - 1) * useful
        codes = np.zeros((Rp, L_rep), dtype=np.uint8)
        ve = np.zeros(Rp, dtype=np.int32)
        base = np.zeros(Rp, dtype=U32)
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
            base[i] = int(batches[s0].win[lane0]) * useful + warmup
            for f in range(7):
                carry_np[f][i] = c7[f]
        carry = enum_ops.MinimizerState(*(jnp.asarray(x)
                                          for x in carry_np))
        em, end = enum_ops.enumerate_batch(
            jnp.asarray(codes), jnp.zeros(Rp, bool), jnp.asarray(ve),
            carry, k=p.k, m=p.m, b=p.b)
        rows = store.make_keys(em.bucket.reshape(-1), em.key.reshape(4, -1),
                               em.mini_idx.reshape(-1), p.k, p.b)
        valid = em.valid.reshape(-1)
        margin = p.k - 1
        L_out = em.valid.shape[1]
        pos = (jnp.asarray(base)[:, None]
               + jnp.arange(L_out, dtype=jnp.uint32)[None, :]).reshape(-1)
        vals = jnp.concatenate(
            [jnp.ones((1, rows.shape[1]), dtype=jnp.uint32)]
            + [pos[None]] * (self.width - 1))
        raw = rows.shape[1]
        if int(self.state.n_used) + raw > self.state.keys.shape[1]:
            self.compact()
        self.state = payload.ensure_room(self.state, raw)
        self.state = payload.append(self.state, rows, vals, valid)
        self.n_emitted += int(jnp.sum(valid))
        km = p.k - p.m
        dede = pyref.get_decycling(p.m)
        f_lo = np.asarray(em.mini_lo)
        f_hi = np.asarray(em.mini_hi)
        f_rc = np.asarray(em.use_rc)
        f_mi = np.asarray(em.mini_idx)
        f_hh = np.asarray(em.hash_hi)
        f_hl = np.asarray(em.hash_lo)
        out = []
        for i in range(R):
            idx = int(ve[i]) - margin - 1
            rev = bool(f_rc[i, idx])
            mi = int(f_mi[i, idx])
            pos_v = (km - mi) if rev else mi
            mini = (int(f_hi[i, idx]) << 32) | int(f_lo[i, idx])
            heavy = dede.mem_double(mini)
            out.append((np.uint32(f_lo[i, idx]), np.uint32(f_hi[i, idx]),
                        np.uint32(pos_v), np.bool_(rev), np.uint32(heavy),
                        np.uint32(f_hh[i, idx]), np.uint32(f_hl[i, idx])))
        return out

    def update(self, kmers, values: np.ndarray) -> None:
        """Batched upsert: merge `values` ((D, n) uint32) into the entries
        of the given k-mer strings under the lane kinds (new keys are
        inserted). The functional replacement for the reference's
        protect_data -> mutate -> unprotect_data cycle. Compaction is
        DEFERRED (capacity-triggered or lazy-on-read) so update streams
        don't pay a device sort per call (VERDICT r2 item 6)."""
        values = np.asarray(values, dtype=U32)
        assert values.shape == (self.width, len(kmers))
        cols = np.stack([self._pack(km) for km in kmers], axis=1)
        if int(self.state.n_used) + len(kmers) > self.state.keys.shape[1]:
            self.compact()
        self.state = payload.ensure_room(self.state, len(kmers))
        self.state = payload.append(self.state, jnp.asarray(cols),
                                    jnp.asarray(values),
                                    jnp.ones(len(kmers), dtype=bool))
        self._dirty = True

    def compact(self) -> None:
        self.state = payload.compact(self.state, self.kinds)
        self._dirty = False

    def _ensure_compact(self) -> None:
        if self._dirty or int(self.state.n_used) > int(self.state.n_sorted):
            self.compact()

    # -- lookup --------------------------------------------------------------

    def _pack(self, kmer: str) -> np.ndarray:
        p = self.params
        if len(kmer) != p.k:
            raise ValueError(f"need a {p.k}-mer, got {len(kmer)} bases")
        dede = pyref.get_decycling(p.m)
        km = pyref.str2kmer_record(kmer, p.m, dede)
        key = pyref.hash_kmer_minimizer(km.kmer, km.minimizer_idx, p.m,
                                        dede)
        slice_hash = pyref.bfc_hash_64(
            (km.kmer >> (2 * km.minimizer_idx)) & p.m_mask, p.m_mask, dede)
        bucket = pyref.bucket_id(slice_hash, p)
        return store.pack_key_np(bucket, key, km.minimizer_idx, p.k, p.b)

    def get(self, kmer: str) -> Optional[Tuple[int, ...]]:
        """All D payload lanes of one k-mer, or None (orientation-
        sensitive keying, like Brisk::get, Brisk.hpp:63-69)."""
        self._ensure_compact()
        cols = self._pack(kmer)[:, None]
        found, vals = payload.lookup(self.state, jnp.asarray(cols))
        if bool(found[0]):
            return tuple(int(v) for v in np.asarray(vals)[:, 0])
        return None

    def items(self) -> Iterator[Tuple[int, Tuple[int, ...]]]:
        """(kmer_value, (lane0, .., laneD-1)) per stored entry."""
        self._ensure_compact()
        n = int(self.state.n_sorted)
        tmp = store.IndexState(self.state.keys,
                               jnp.ones(self.state.keys.shape[1], U32),
                               self.state.n_sorted, self.state.n_used)
        _, hi, lo, _, _ = readout.entries_u64(tmp, self.params)
        data = np.asarray(self.state.data)[:, :n]
        for i in range(n):
            kv = (int(hi[i]) << 64) | int(lo[i])
            yield kv, tuple(int(x) for x in data[:, i])

    # -- maintenance ---------------------------------------------------------

    def reallocate(self) -> None:
        """m += 2, b += 2 re-keying with payload lanes carried; collapsing
        entries merge under the lane kinds (the reference keeps an
        arbitrary one, Brisk.hpp:219 — see index.rekey's deviation
        note)."""
        from brisk_tpu.index import rekey
        p = self.params
        new = Parameters(k=p.k, m=p.m + 2, b=min(p.b + 2, 15))
        self._ensure_compact()
        n = int(self.state.n_sorted)
        tmp = store.IndexState(self.state.keys,
                               jnp.ones(self.state.keys.shape[1], U32),
                               self.state.n_sorted, self.state.n_used)
        _, hi, lo, _, _ = readout.entries_u64(tmp, p)
        vals = np.asarray(self.state.data)[:, :n]
        out = payload.empty(max(1 << 10, int(2 ** np.ceil(
            np.log2(max(n, 1) * 2)))), store.key_words(new.k, new.b),
            self.width)
        batch = 1 << 16
        for s in range(0, n, batch):
            e = min(s + batch, n)
            codes = rekey._codes_from_values(hi[s:e], lo[s:e], new.k)
            rows = rekey._rekey_batch(jnp.asarray(codes), k=new.k,
                                      m=new.m, b=new.b)
            out = payload.ensure_room(out, rows.shape[1])
            out = payload.append(out, rows, jnp.asarray(vals[:, s:e]),
                                 jnp.ones(rows.shape[1], dtype=bool))
        self.state = payload.compact(out, self.kinds)
        self.params = new

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        self._ensure_compact()
        np.savez_compressed(
            path, keys=np.asarray(self.state.keys),
            data=np.asarray(self.state.data),
            n_sorted=int(self.state.n_sorted),
            n_used=int(self.state.n_used),
            k=self.params.k, m=self.params.m, b=self.params.b,
            kinds=np.array(self.kinds), n_emitted=self.n_emitted)

    @classmethod
    def load(cls, path: str, **kw) -> "BriskData":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        params = Parameters(k=int(z["k"]), m=int(z["m"]), b=int(z["b"]))
        kinds = tuple(str(x) for x in z["kinds"])
        self = cls(params, width=len(kinds), kinds=kinds,
                   capacity=z["keys"].shape[1], **kw)
        self.state = payload.PayloadState(
            keys=jnp.asarray(z["keys"]), data=jnp.asarray(z["data"]),
            n_sorted=jnp.int32(int(z["n_sorted"])),
            n_used=jnp.int32(int(z["n_used"])))
        self.n_emitted = int(z["n_emitted"])
        return self
