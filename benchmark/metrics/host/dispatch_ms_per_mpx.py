"""host.dispatch_ms_per_mpx: host ms that the port's `sjpeg.request`
spans own themselves in the traced slice, outside every inner span: the
Python and torch path that issues the glue and the kernels, a megapixel
of the requests, with the card's idle ms inside them; see
host/transfer_ms_per_mpx.py."""

from benchmark.metrics.host.transfer_ms_per_mpx import host_ms


def read(t):
    return host_ms(t, ("sjpeg.request",))
