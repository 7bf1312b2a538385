"""Device memory that the graph, streamed-round and device-POA budgets are
derived from."""

from __future__ import annotations

import jax

# The CPU backend reports no memory limit.  Only the tests run there; this
# fixed budget is the CPU's and keeps their routing independent of the host.
CPU_BUDGET_BYTES = 6 << 30


def device_memory_bytes(device=None) -> int:
    """Bytes the device's allocator may hand out (`bytes_limit`).

    Raises on an accelerator that reports none: a budget guessed for the
    wrong card either wastes most of it or runs out of memory."""
    dev = device if device is not None else jax.devices()[0]
    if dev.platform == "cpu":
        return CPU_BUDGET_BYTES
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{dev.device_kind} reports no bytes_limit in memory_stats(); "
            "pass the memory budget explicitly (-f GB)"
        )
    return int(limit)
