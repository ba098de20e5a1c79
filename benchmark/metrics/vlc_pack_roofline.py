"""vlc_pack_roofline: the least time the optimal-table pack stage's work
needs on the card over the device time of the vlc_pack kernel, in %.

The stage (Huffman code and pack the quantized levels) fixes its work
whatever implements it: each block's 64 levels in (2 B each: baseline
values fit 12 bits), the scan's bits out (its bytes before stuffing) and
the tables once an image (the DQT and DHT payloads).  It has no fDCT, so
its bytes bound it."""

from benchmark import jpeg_info, roofline


def work(blocks: int, scan_bytes: int, table_bytes: int) -> int:
    """Bytes of the stage over that many blocks."""
    return 2 * 64 * blocks + scan_bytes + table_bytes


def read(t):
    info = [jpeg_info.parse(j) for j in t.jpegs]
    nbytes = work(sum(i.blocks for i in info),
                  sum(i.scan_bytes for i in info),
                  sum(i.table_bytes for i in info))
    return roofline.share(t, "vlc_pack", nbytes, 0)
