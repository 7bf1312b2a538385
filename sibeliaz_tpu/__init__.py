"""sibeliaz_tpu — a device-accelerated whole-genome aligner / locally collinear block (LCB) builder.

A from-scratch JAX/XLA re-design of the capabilities of SibeliaZ
(reference: medvedevgroup/SibeliaZ v1.2.7):

  * compacted de Bruijn graph junction enumeration (TwoPaCo stage) as a
    sort-based, exactly-batched XLA program (``sibeliaz_tpu.graph``),
  * locally collinear block construction via greedy carrier-path extension
    with speculative phase-parallelism and deterministic serial commit
    (``sibeliaz_tpu.lcb``),
  * partial-order-alignment MSA of block copies (spoa stage) as batched
    wavefront DP (``sibeliaz_tpu.align``),
  * GFF3 / MAF serialization byte-compatible with the reference
    (``sibeliaz_tpu.output``),
  * multi-device scaling via jax.sharding meshes with sequence-axis halo
    sharding (``sibeliaz_tpu.parallel``).

64-bit integer support is required for exact k-mer codes (2 bits/char,
k <= 31 fits int64); we enable it globally at import, before any JAX
computation happens.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)


def compile_cache_dir(environ=_os.environ):
    """Where this package keeps JAX's persistent compilation cache, or None
    when JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    # a fixed path inside the checkout: the path is part of the cache key
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


# Persistent compilation cache: caching makes the junction kernels'
# compile a once-per-checkout cost.
_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

from sibeliaz_tpu.config import Config  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Config", "__version__"]
