"""Published peak rates of the devices the roofline harnesses divide by.

Keyed by `jax.devices()[0].device_kind`.  A device that is not listed is
an error, not a default: a roofline share against the wrong peak is
worse than none.
"""

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: 80 GB HBM3 at
# 3.35 TB/s (at the card's full 700 W power limit).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device) -> float:
    kind = device.device_kind
    if kind not in HBM_BYTES_PER_S:
        raise KeyError(
            f"no published memory bandwidth for device_kind {kind!r}; "
            "add it to benchmarks/peaks.py with its source"
        )
    return HBM_BYTES_PER_S[kind]
