"""host.analysis_ms_per_mpx: host ms that the port's `sjpeg.analysis`
spans own in the traced slice (the lambda fit, the host Huffman tables and
LUTs, the exact-table AUTO scorer), a megapixel of its requests, with the
card's idle ms inside them; see host/transfer_ms_per_mpx.py."""

from benchmark.metrics.host.transfer_ms_per_mpx import host_ms


def read(t):
    return host_ms(t, ("sjpeg.analysis",))
