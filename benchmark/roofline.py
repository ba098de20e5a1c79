"""The yardstick of a kernel's roofline share: the card's published peaks
and the least time that a stage's bytes and operations need.

Peaks are NVIDIA's H100 SXM data sheet at its 700 W limit: 3.35 TB/s of HBM
and 67 T/s of float32 operations outside the tensor cores (the sheet gives
no integer rate for them; a JPEG stage's integer work is counted against
it).  A share is stated with the card's power limit beside it."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def least_seconds(nbytes: int, ops: int) -> tuple:
    """(seconds, which bound binds: "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(t, family: str, nbytes: int, ops: int):
    """The roofline share, in %, of the kernels of `family` in the trace
    view `t`, or None when none of them ran in it."""
    us = t.device_us(lambda e: e["cat"] == "kernel"
                     and t.is_port_kernel(e["name"], family))
    if us <= 0:
        return None
    least, bound = least_seconds(nbytes, ops)
    return {"value": 100.0 * least / (us / 1e6), "bound": bound,
            "device_us": us, "power_limit_w": t.power_limit_w}
