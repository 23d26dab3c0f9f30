"""MSC packet mode (ETSI EN 300 401 s5.3.2): MSC data groups <-> packets.

Reference counterpart: none — upstream dabtools is stream-mode audio only
(`upstream:eti2mpa.c`, SURVEY.md R17).  Packet mode is the transport for
DAB data services (EPG, TPEG, packet-mode MOT); this module + FIG 0/3
signalling make such services extractable from our ETI, a beyond-reference
extension in the spirit of the MOT/EDI ones.

Wire format [K-med — reconstructed from the public standard; verify
against a real capture, docs/INTEROP.md]:

* A packet is 24, 48, 72 or 96 bytes: a 3-byte header
  (packet length(2) | continuity(2) | first(1) | last(1) | address(10) |
  command(1) | useful data length(7)), the data field, padding, and a
  2-byte CRC (same CRC-16/CCITT convention as FIBs) over everything
  before it.
* Packets of one address chain into an MSC data group: first/last flags
  bracket it, the 2-bit continuity index increments mod 4 per packet of
  that address.
* Address 0 is reserved for padding packets, which receivers discard.

All host-side byte work (like the ETI assembler): the TPU's job ended at
the convolutional decode of the sub-channel; packets are control-plane.
"""

from __future__ import annotations

import dataclasses

from dabtools_tpu_torch.utils.crc import crc16_ccitt

PACKET_SIZES = (24, 48, 72, 96)
PADDING_ADDRESS = 0
_HEADER_LEN = 3
_CRC_LEN = 2
_OVERHEAD = _HEADER_LEN + _CRC_LEN


def build_packet(address: int, data: bytes, continuity: int,
                 first: bool, last: bool, packet_size: int = 96,
                 command: bool = False) -> bytes:
    """One packet carrying ``data`` (padded to ``packet_size``)."""
    if packet_size not in PACKET_SIZES:
        raise ValueError(f"packet size must be one of {PACKET_SIZES}")
    if len(data) > packet_size - _OVERHEAD:
        raise ValueError("data exceeds packet capacity")
    if not 0 <= address < 1024:
        raise ValueError("packet address is 10 bits")
    b0 = ((packet_size // 24 - 1) << 6 | (continuity & 3) << 4
          | (1 if first else 0) << 3 | (1 if last else 0) << 2
          | address >> 8)
    b1 = address & 0xFF
    b2 = (0x80 if command else 0) | len(data)
    body = bytes([b0, b1, b2]) + data
    body += b"\x00" * (packet_size - _CRC_LEN - len(body))
    return body + crc16_ccitt(body).to_bytes(2, "big")


def padding_packet(packet_size: int = 24) -> bytes:
    return build_packet(PADDING_ADDRESS, b"", 0, False, False, packet_size)


class PacketEncoder:
    """MSC data groups -> a padded packet stream for one sub-channel.

    ``add_data_group`` queues the packets of one data group (the final
    packet shrinks to the smallest standard size that holds the tail);
    ``take_frame`` pops one logical frame's worth, padding the remainder
    with address-0 packets so every frame is exactly full.
    """

    def __init__(self, address: int, packet_size: int = 96):
        if packet_size not in PACKET_SIZES:
            raise ValueError(f"packet size must be one of {PACKET_SIZES}")
        self.address = address
        self.packet_size = packet_size
        self._queue: list[bytes] = []
        self._continuity = 0

    def _push(self, data: bytes, first: bool, last: bool) -> None:
        size = self.packet_size
        if last:                       # shrink the tail packet
            size = next(s for s in PACKET_SIZES if s >= len(data) + _OVERHEAD)
        self._queue.append(build_packet(
            self.address, data, self._continuity, first, last, size))
        self._continuity = (self._continuity + 1) & 3

    def add_data_group(self, dg: bytes) -> None:
        cap = self.packet_size - _OVERHEAD
        chunks = [dg[i:i + cap] for i in range(0, max(len(dg), 1), cap)]
        for i, chunk in enumerate(chunks):
            self._push(chunk, first=(i == 0), last=(i == len(chunks) - 1))

    @property
    def pending_bytes(self) -> int:
        return sum(len(p) for p in self._queue)

    def take_packet(self) -> bytes | None:
        """Pop one whole packet (for outer framers, e.g. `pfec.FecEncoder`)."""
        return self._queue.pop(0) if self._queue else None

    def take_frame(self, frame_bytes: int) -> bytes:
        """Exactly ``frame_bytes`` of packet stream (multiple of 24)."""
        if frame_bytes % 24:
            raise ValueError("packet-mode sub-channel frames are n x 24 B")
        if self._queue and len(self._queue[0]) > frame_bytes:
            # would never drain: the standard drain loop (`while
            # pending_bytes: take_frame(...)`) must not spin forever
            raise ValueError(
                f"packet size {len(self._queue[0])} exceeds the "
                f"sub-channel frame capacity {frame_bytes}; construct the "
                f"encoder with packet_size <= frame capacity")
        out = bytearray()
        while self._queue and len(out) + len(self._queue[0]) <= frame_bytes:
            out += self._queue.pop(0)
        while len(out) < frame_bytes:   # pad with the largest fitting size
            pad = next(s for s in reversed(PACKET_SIZES)
                       if s <= frame_bytes - len(out))
            out += padding_packet(pad)
        return bytes(out)


@dataclasses.dataclass
class _Assembly:
    data: bytearray
    continuity: int


class PacketDecoder:
    """Packet stream -> (address, data-group bytes) pairs.

    Stream-robust: buffers across ``feed`` calls (packets may straddle
    logical frames), resynchronizes byte-by-byte on CRC failure, checks
    per-address continuity, and drops partial groups on any gap —
    the data group's own CRC (checked downstream) is the final gate.
    """

    def __init__(self):
        self._buf = bytearray()
        self._asm: dict[int, _Assembly] = {}
        self.stats = {"packets": 0, "padding": 0, "crc_failures": 0,
                      "continuity_errors": 0, "orphans": 0, "command": 0,
                      "malformed": 0, "data_groups": 0}

    def feed(self, data: bytes) -> list[tuple[int, bytes]]:
        self._buf += data
        out: list[tuple[int, bytes]] = []
        while len(self._buf) >= 24:
            size = ((self._buf[0] >> 6) + 1) * 24
            if len(self._buf) < size:
                break
            pkt = bytes(self._buf[:size])
            if crc16_ccitt(pkt[:-2]) != int.from_bytes(pkt[-2:], "big"):
                del self._buf[0]       # resync one byte at a time
                self.stats["crc_failures"] += 1
                continue
            del self._buf[:size]
            self.stats["packets"] += 1
            address = (pkt[0] & 3) << 8 | pkt[1]
            continuity = pkt[0] >> 4 & 3
            if address == PADDING_ADDRESS:
                self.stats["padding"] += 1
                continue
            if pkt[2] & 0x80:          # command packet (e.g. CA): not data,
                self.stats["command"] += 1   # but it advances the address's
                st = self._asm.get(address)  # continuity chain
                if st is not None and (st.continuity + 1) & 3 == continuity:
                    st.continuity = continuity
                continue
            if (pkt[2] & 0x7F) > size - _OVERHEAD:
                # CRC-aliased corrupt header: never leak padding/CRC bytes
                # into a data group
                self.stats["malformed"] += 1
                continue
            first, last = pkt[0] >> 3 & 1, pkt[0] >> 2 & 1
            useful = pkt[_HEADER_LEN:_HEADER_LEN + (pkt[2] & 0x7F)]
            st = self._asm.get(address)
            if first:
                if st is not None:
                    self.stats["continuity_errors"] += 1
                st = _Assembly(bytearray(useful), continuity)
                self._asm[address] = st
            elif st is None:
                self.stats["orphans"] += 1
                continue
            elif (st.continuity + 1) & 3 != continuity:
                self.stats["continuity_errors"] += 1
                del self._asm[address]
                continue
            else:
                st.continuity = continuity
                st.data += useful
            if last:
                out.append((address, bytes(st.data)))
                self.stats["data_groups"] += 1
                del self._asm[address]
        return out
