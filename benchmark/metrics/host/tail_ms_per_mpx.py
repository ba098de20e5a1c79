"""host.tail_ms_per_mpx: host ms that the port's `sjpeg.tail` spans own
in the traced slice (from the fetched words to the returned bytes: byte
stuffing, table descriptions, headers, assembly), a megapixel of its
requests, with the card's idle ms inside them; see
host/transfer_ms_per_mpx.py."""

from benchmark.metrics.host.transfer_ms_per_mpx import host_ms


def read(t):
    return host_ms(t, ("sjpeg.tail",))
