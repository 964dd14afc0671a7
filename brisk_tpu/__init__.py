"""brisk_tpu: a dynamic k-mer counting/indexing engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the Brisk
reference library (C++17): 2-bit-packed k-mers up to k=63,
minimizer-driven super-k-mer decomposition, and a dynamic minimizer-bucketed
dictionary mapping each k-mer to mutable per-k-mer payloads — here re-imagined
as batched, functional, sorted-array index state sharded over a device mesh
instead of mutexed pointer-chasing buckets.

Count parity contract: byte-exact against the reference `counter` app's
mode-2 oracle (reference apps/counter.cpp:247-258).
"""

import os as _os

import jax as _jax

# Persistent compilation cache: index programs are compiled per
# (batch, window, capacity) shape family, and a process that finds them
# cached skips the compile. JAX_COMPILATION_CACHE_DIR, when set, is JAX's
# own setting and wins. Otherwise the cache lives at one fixed directory
# inside the checkout (a cache directory that moves never hits). The CPU
# backend gets no default: serializing large XLA:CPU executables
# (k=63 programs) reproducibly segfaults.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
_cache_dir = None


def enable_persistent_cache():
    """Turn on the persistent compilation cache for this process and
    return its directory, or None on the CPU backend without
    JAX_COMPILATION_CACHE_DIR. Call before the first compile: JAX decides
    once per process whether the cache is used. Called by the entry
    points (Brisk, ShardedBrisk, chip_smoke.py); safe to call again."""
    global _cache_dir
    if _cache_dir is not None:
        return _cache_dir
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if _jax.default_backend() == "cpu":
        return env or None
    if not env:
        _os.makedirs(CACHE_DIR, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # cache every program: most compile in well under JAX's 1 s default
    # threshold, but a cold process compiles hundreds of them
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    _cache_dir = env or CACHE_DIR
    return _cache_dir


from brisk_tpu.params import Parameters  # noqa: E402

__all__ = ["Parameters"]
__version__ = "0.1.0"
