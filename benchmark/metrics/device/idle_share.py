"""device.idle_share: the share of the traced slice's host-clock span in
which the card ran no kernel, copy or memset."""


def read(t):
    span = t.hi - t.lo
    return 1.0 - t.busy_us / span if span > 0 and t.events else None
