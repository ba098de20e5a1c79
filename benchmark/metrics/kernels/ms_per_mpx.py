"""kernels.ms_per_mpx: device ms of the port's own kernels (the names of
kernels/<family>.json) in the traced slice, a megapixel of its requests."""


def read(t):
    us = t.device_us(lambda e: e["cat"] == "kernel"
                     and t.is_port_kernel(e["name"]))
    return us / 1e3 / t.mpx if us > 0 else None
