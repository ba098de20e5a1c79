"""trellis_roofline: the least time the trellis stage's work needs on the
card over the device time of the trellis op's four kernels, in %.

The stage (rate-distortion quantization of the AC levels, method 7) fixes
its work whatever implements it: each block's 64 coefficients in and 64
levels out (2 B a value: baseline values fit 12 bits; no dtype counted),
and once an image the two quantizer matrices and the [2, 256] AC code
lengths of the rate model, 2 B a value as well.

Its operations are not counted: the search scores each opened level
against the sink and every level opened before it, so their number
depends on the source coefficients, which the traced JPEGs do not carry.
The share is therefore taken against the bytes alone, and can understate
the share against both bounds.  On the 16 x 1024^2 batch (393,216 blocks)
that PERF.md's kernel table times, the bytes counted here need 30.05 us
and the search's scores 43.4 us at 67 T/s: there the share reads up to
1.44 x too low."""

from benchmark import jpeg_info, roofline

VALUE_BYTES = 2
# a block's coefficients in and levels out; an image's two matrices and
# two rows of AC code lengths
BLOCK_VALUES = 64 + 64
IMAGE_VALUES = 2 * 64 + 2 * 256


def work(blocks: int, images: int) -> int:
    """Bytes of the stage over that many blocks of that many images."""
    return VALUE_BYTES * (BLOCK_VALUES * blocks + IMAGE_VALUES * images)


def read(t):
    info = [jpeg_info.parse(j) for j in t.jpegs]
    return roofline.share(t, "trellis",
                          work(sum(i.blocks for i in info), len(info)), 0)
