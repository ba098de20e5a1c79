"""transfer.ms_per_mpx: device ms of host-to-device and device-to-host
copies in the traced slice, a megapixel of its requests."""


def read(t):
    us = t.device_us(lambda e: e["cat"] == "gpu_memcpy" and (
        e["name"].startswith("Memcpy HtoD")
        or e["name"].startswith("Memcpy DtoH")))
    return us / 1e3 / t.mpx if us > 0 else None
