"""host.trellis_ms_per_mpx: host ms that the port's `sjpeg.trellis` spans
own in the traced slice (method 7's quantizer stage: the MCU interleave,
the trellis op's launches, the VLC fields and symbol frequencies), a
megapixel of its requests, with the card's idle ms inside them; see
host/transfer_ms_per_mpx.py.  A slice without such a span (a program
that opens none, or a method without the trellis) gives nothing."""

from benchmark.metrics.host.transfer_ms_per_mpx import host_ms, slice_spans

NAMES = ("sjpeg.trellis",)


def read(t):
    if not any(name in NAMES for _, _, name, _ in slice_spans(t)):
        return None
    return host_ms(t, NAMES)
