"""What a baseline JPEG states of its own work: the frame's size and
sampling (so its 8x8 blocks), its tables' bytes and its entropy-coded
scan's bytes before 0xFF stuffing."""

from dataclasses import dataclass


@dataclass
class JpegWork:
    width: int
    height: int
    blocks: int          # 8x8 blocks over every component
    table_bytes: int     # DQT and DHT payloads
    scan_bytes: int      # the scan without its stuffed zero bytes


def parse(jpeg: bytes) -> JpegWork:
    pos, table_bytes, frame = 2, 0, None
    while pos < len(jpeg):
        if jpeg[pos] != 0xFF:
            raise ValueError(f"no marker at byte {pos}")
        marker = jpeg[pos + 1]
        size = (jpeg[pos + 2] << 8) | jpeg[pos + 3]
        body = jpeg[pos + 4:pos + 2 + size]
        if marker in (0xDB, 0xC4):
            table_bytes += size - 2
        elif marker == 0xC0:
            frame = body
        elif marker == 0xDA:
            scan = jpeg[pos + 2 + size:len(jpeg) - 2]
            break
        pos += 2 + size
    else:
        raise ValueError("no SOS marker")
    height = (frame[1] << 8) | frame[2]
    width = (frame[3] << 8) | frame[4]
    comps = [(frame[6 + 3 * c + 1] >> 4, frame[6 + 3 * c + 1] & 15)
             for c in range(frame[5])]
    hmax = max(h for h, _ in comps)
    vmax = max(v for _, v in comps)
    mcu_w = -(-width // (8 * hmax))
    mcu_h = -(-height // (8 * vmax))
    blocks = sum(mcu_w * mcu_h * h * v for h, v in comps)
    return JpegWork(width, height, blocks, table_bytes,
                    len(scan) - scan.count(b"\xff\x00"))
