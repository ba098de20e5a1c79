"""glue.ms_per_mpx: device ms of the kernels that are not the port's own
(torch's element-wise ops, reductions, scatters, scans, fills) in the
traced slice, a megapixel of its requests; copies and memsets are not
counted."""


def read(t):
    us = t.device_us(lambda e: e["cat"] == "kernel"
                     and not t.is_port_kernel(e["name"]))
    return us / 1e3 / t.mpx if us > 0 else None
