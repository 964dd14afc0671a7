"""Multi-host distributed runtime (SURVEY §5.8, P5).

The reference's scale ceiling is one shared-memory process (OpenMP +
per-minimizer lock groups, DenseMenuYo.hpp:110-118). The multi-host
replacement: every host runs the SAME program under
`jax.distributed`, the mesh spans all hosts' devices, and the existing
shard_map programs (parallel.sharded) run unchanged — XLA inserts the
all_to_all emission routing from the same collective within and across
hosts. Tested on CPU processes only; it has not run on GPUs.

Host-major device order: the 1-D "x" axis enumerates processes' devices
contiguously (process 0's chips, then process 1's, ...), so
bucket % n_shards routing keeps maximal locality per host block and a
host's lanes are its own slice of the global batch.

Global arrays are built with `jax.make_array_from_callback`: each
process materializes ONLY its addressable shards, so no host ever holds
(or ships) the whole index. Replicated outputs (stats) are readable on
every host; per-shard state is read back via `addressable_shards`.

Validated by tests/test_multihost.py: 2 processes x 4 virtual CPU
devices on localhost with exact count parity vs the oracle.
"""

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from brisk_tpu.index import store


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join the distributed runtime (idempotent per process)."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh() -> Mesh:
    """1-D host-major mesh over every device of every process."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), axis_names=("x",))


def make_global(mesh: Mesh, shape, dtype,
                fill: Callable[[tuple], np.ndarray]) -> jax.Array:
    """Build a global array sharded P('x') on the leading axis; `fill`
    receives the NORMALIZED global index tuple (concrete slices) of one
    shard and returns its block. Only addressable shards are
    materialized on this process."""
    shape = tuple(shape)
    sharding = NamedSharding(mesh, P("x"))

    def cb(idx):
        norm = tuple(slice(*s.indices(n)[:2]) for s, n in zip(idx, shape))
        return np.ascontiguousarray(fill(norm))

    return jax.make_array_from_callback(shape, sharding, cb)


def sharded_empty_global(n_shards: int, capacity: int, mesh: Mesh,
                         nkey: int) -> store.IndexState:
    """parallel.sharded.sharded_empty for a multi-process mesh: each
    process allocates only its own shards."""
    def mk(shape, dt, fillval):
        return make_global(
            mesh, shape, dt,
            lambda idx: np.full(tuple(s.stop - s.start for s in idx),
                                fillval, dtype=dt))

    return store.IndexState(
        keys=mk((n_shards, nkey, capacity), np.uint32, 0xFFFFFFFF),
        data=mk((n_shards, capacity), np.uint32, 0),
        n_sorted=mk((n_shards,), np.int32, 0),
        n_used=mk((n_shards,), np.int32, 0))


def shard_batch(mesh: Mesh, host_array: np.ndarray) -> jax.Array:
    """Shard a host-replicated batch array over the mesh's leading axis
    (every process holds the same full `host_array`; each materializes
    only its lanes)."""
    return make_global(mesh, host_array.shape, host_array.dtype,
                       lambda idx: host_array[idx])


def make_global_spec(mesh: Mesh, shape, dtype, spec: P,
                     fill: Callable[[tuple], np.ndarray]) -> jax.Array:
    """make_global with an arbitrary PartitionSpec (e.g. P(None, 'x')
    for lane-sharded window stacks)."""
    shape = tuple(shape)
    sharding = NamedSharding(mesh, spec)

    def cb(idx):
        norm = tuple(slice(*s.indices(n)[:2]) for s, n in zip(idx, shape))
        out = np.ascontiguousarray(fill(norm))
        return out.reshape(tuple(s.stop - s.start for s in norm))

    return jax.make_array_from_callback(shape, sharding, cb)


def lane_sharded(mesh: Mesh, shape, local_block: np.ndarray,
                 lane_axis: int, lane_offset: int) -> jax.Array:
    """Build a global array sharded over `lane_axis` where THIS process
    supplies only its contiguous lane block [lane_offset,
    lane_offset + local_block.shape[lane_axis]) — the host-major
    data-parallel input layout (each process packs only its own
    records' windows, VERDICT r2 item 3)."""
    spec = P(*([None] * lane_axis + ["x"]))

    def fill(idx):
        sl = idx[lane_axis]
        lo = sl.start - lane_offset
        hi = sl.stop - lane_offset
        assert 0 <= lo and hi <= local_block.shape[lane_axis], \
            (sl, lane_offset, local_block.shape)
        sel = list(idx)
        sel[lane_axis] = slice(lo, hi)
        return local_block[tuple(sel)]

    return make_global_spec(mesh, shape, local_block.dtype, spec, fill)


def replicate(mesh: Mesh, tree):
    """Place a pytree of host scalars/arrays fully REPLICATED on a
    (possibly multi-process) mesh — e.g. the window-continuity chain
    carry or a query batch."""
    def one(x):
        x = np.asarray(x)
        return make_global_spec(mesh, x.shape, x.dtype, P(),
                                lambda idx: x[idx])

    return jax.tree.map(one, tree)


def lane_block(arr: jax.Array, lane_axis: int):
    """(offset, numpy block) of THIS process's contiguous slice of a
    lane-sharded global array (reading np.asarray on the whole array
    would fail cross-process)."""
    pieces = {}
    for s in arr.addressable_shards:
        sl = s.index[lane_axis]
        start = sl.start if isinstance(sl, slice) else sl
        pieces[start or 0] = np.asarray(s.data)
    starts = sorted(pieces)
    blocks = [pieces[st] for st in starts]
    prev = starts[0]
    for st, blk in zip(starts[1:], blocks[:-1]):
        assert st == prev + blk.shape[lane_axis], "non-contiguous lanes"
        prev = st
    return starts[0], np.concatenate(blocks, axis=lane_axis)


def process_max(value: int) -> int:
    """Max of a per-process host integer across all processes (host
    collective; single-process: identity)."""
    if jax.process_count() == 1:
        return int(value)
    from jax.experimental import multihost_utils
    allv = multihost_utils.process_allgather(np.asarray([value]))
    return int(np.max(allv))


def process_sum(value: int) -> int:
    """Sum of a per-process host integer across all processes."""
    if jax.process_count() == 1:
        return int(value)
    from jax.experimental import multihost_utils
    allv = multihost_utils.process_allgather(np.asarray([value]))
    return int(np.sum(allv))


def local_entries(state: store.IndexState):
    """Yield (shard_id, local IndexState as numpy views) for every shard
    addressable by THIS process (for host-side readout/export; a pod
    export concatenates per-host outputs)."""
    keys_sh = {s.index[0].start if isinstance(s.index[0], slice)
               else s.index[0]: np.asarray(s.data)
               for s in state.keys.addressable_shards}
    data_sh = {s.index[0].start if isinstance(s.index[0], slice)
               else s.index[0]: np.asarray(s.data)
               for s in state.data.addressable_shards}
    ns_sh = {s.index[0].start if isinstance(s.index[0], slice)
             else s.index[0]: np.asarray(s.data)
             for s in state.n_sorted.addressable_shards}
    nu_sh = {s.index[0].start if isinstance(s.index[0], slice)
             else s.index[0]: np.asarray(s.data)
             for s in state.n_used.addressable_shards}
    for d in sorted(keys_sh):
        yield d, store.IndexState(
            keys=jnp.asarray(keys_sh[d][0]),
            data=jnp.asarray(data_sh[d][0]),
            n_sorted=jnp.int32(int(ns_sh[d][0])),
            n_used=jnp.int32(int(nu_sh[d][0])))
