"""sample_pack_roofline: the least time the fixed-table stage's work needs
on the card over the device time of the sample_pack kernel, in %.

The stage (fDCT, quantize, Huffman code and pack) fixes its work whatever
implements it: each block's 64 8-bit samples in (1 B each), the scan's
bits out (its bytes before stuffing), the tables once an image (the DQT and
DHT payloads), and the fDCT's operations, counted a block."""

from benchmark import jpeg_info, roofline

# sjpeg's integer fDCT (src/fdct.cc:67-209) counted by hand, each add,
# subtract, multiply and shift one operation: 54 a column (the 8-point
# butterflies, the pre-shifts, the tan / sqrt(2) products), 58 a row (the
# 8 sums and differences, 4 even-part sums, 16 multiplies of the odd part
# with their sums, the 8 shifts)
FDCT_OPS_PER_BLOCK = 8 * 54 + 8 * 58


def work(blocks: int, scan_bytes: int, table_bytes: int) -> tuple:
    """(bytes, operations) of the stage over that many blocks."""
    return (64 * blocks + scan_bytes + table_bytes,
            FDCT_OPS_PER_BLOCK * blocks)


def read(t):
    info = [jpeg_info.parse(j) for j in t.jpegs]
    nbytes, ops = work(sum(i.blocks for i in info),
                       sum(i.scan_bytes for i in info),
                       sum(i.table_bytes for i in info))
    return roofline.share(t, "sample_pack", nbytes, ops)
