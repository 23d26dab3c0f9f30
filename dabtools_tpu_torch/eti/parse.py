"""ETI(NI) stream parsing + sub-channel extraction (N11).

Reference counterpart: `upstream:eti2mpa.c` (R17): resync on FSYNC, parse
FC/STC, slice the target sub-channel's bytes out of the MST.  Field packing
mirrors ``eti/assemble.py`` (see its [K-med] note).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterator

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.utils.crc import crc16_ok


@dataclasses.dataclass
class EtiStream:
    subchid: int
    sad_words: int
    tpl: int
    stl_words: int
    data: bytes


@dataclasses.dataclass
class EtiFrame:
    err: int
    fct: int
    fp: int
    mid: int
    fic: bytes
    streams: dict[int, EtiStream]
    header_crc_ok: bool
    mst_crc_ok: bool
    tist: int | None = None     # ticks of 1/16.384 MHz within the second

    @property
    def tist_seconds(self) -> float | None:
        from dabtools_tpu_torch.eti.assemble import TIST_TICKS_PER_SEC
        return None if self.tist is None else self.tist / TIST_TICKS_PER_SEC

    def subchannel_data(self, subchid: int) -> bytes:
        return self.streams[subchid].data


class EtiParser:
    """Incremental ETI(NI) parser with FSYNC resynchronisation."""

    def __init__(self, mode=C.MODE_I):
        self.mode = mode
        self._buf = bytearray()
        self.resyncs = 0

    def feed(self, data: bytes) -> Iterator[EtiFrame]:
        self._buf += data
        while True:
            frame = self._try_frame()
            if frame is None:
                return
            yield frame

    def _try_frame(self) -> EtiFrame | None:
        buf = self._buf
        while True:
            if len(buf) < C.ETI_FRAME_BYTES:
                return None
            fsync = int.from_bytes(buf[1:4], "big")
            if fsync in (C.ETI_FSYNC, C.ETI_FSYNC_INV):
                break
            # hunt for the next FSYNC (either polarity)
            pos = _find_fsync(buf, start=1)
            self.resyncs += 1
            if pos < 0:
                del buf[:-3]
                return None
            del buf[:pos - 1]      # keep the ERR byte slot before FSYNC
        raw = bytes(buf[:C.ETI_FRAME_BYTES])
        del buf[:C.ETI_FRAME_BYTES]
        return self._parse(raw)

    def _parse(self, raw: bytes) -> EtiFrame:
        err = raw[0]
        fc = raw[4:8]
        fct = fc[0]
        ficf = fc[1] >> 7
        nst = fc[1] & 0x7F
        fp = fc[2] >> 5
        mid = (fc[2] >> 3) & 0x03
        fl_words = ((fc[2] & 0x07) << 8) | fc[3]

        stc_raw = raw[8:8 + 4 * nst]
        eoh = raw[8 + 4 * nst: 8 + 4 * nst + 4]
        header_crc_ok = crc16_ok(fc + stc_raw + eoh)

        mst_start = 8 + 4 * nst + 4
        mst_len = 4 * fl_words - 4 * nst - 4
        if not header_crc_ok or mst_len < 0 or (
                mst_start + mst_len + 8 > C.ETI_FRAME_BYTES):
            # A corrupt FC (bit error, false FSYNC lock) makes NST/FL —
            # and with them every slice offset below — garbage; emit a
            # frame that carries the damage verdict but no data rather
            # than feeding misaddressed bytes downstream.
            return EtiFrame(err=err, fct=fct, fp=fp, mid=mid, fic=b"",
                            streams={}, header_crc_ok=False,
                            mst_crc_ok=False)
        mst = raw[mst_start: mst_start + mst_len]
        eof = raw[mst_start + mst_len: mst_start + mst_len + 4]
        mst_crc_ok = crc16_ok(mst + eof[:2])
        tist_raw = int.from_bytes(
            raw[mst_start + mst_len + 4: mst_start + mst_len + 8], "big")
        tist = None if tist_raw == 0xFFFFFFFF else tist_raw

        fic_len = (self.mode.n_fibs // self.mode.n_cifs * C.FIB_BYTES
                   if ficf else 0)
        fic = mst[:fic_len]
        streams: dict[int, EtiStream] = {}
        for i in range(nst):
            # SCID(6) SAD(10) TPL(6) STL(10) — ETS 300 799 STC entry
            e = stc_raw[4 * i: 4 * i + 4]
            subchid = e[0] >> 2
            sad = ((e[0] & 0x03) << 8) | e[1]
            tpl = e[2] >> 2
            stl = ((e[2] & 0x03) << 8) | e[3]
            data = mst[sad * 8: sad * 8 + stl * 8]
            streams[subchid] = EtiStream(subchid, sad, tpl, stl, data)
        return EtiFrame(err=err, fct=fct, fp=fp, mid=mid, fic=fic,
                        streams=streams, header_crc_ok=header_crc_ok,
                        mst_crc_ok=mst_crc_ok, tist=tist)


def _find_fsync(buf: bytearray, start: int) -> int:
    """Python FSYNC hunt (bytes.find is memchr-fast and zero-copy, so it
    stays the production path; the native `dabhost_eti_find_fsync` is the
    cross-checked alternative — equivalence pinned in tests/test_native)."""
    a = C.ETI_FSYNC.to_bytes(3, "big")
    b = C.ETI_FSYNC_INV.to_bytes(3, "big")
    pa, pb = buf.find(a, start + 1), buf.find(b, start + 1)
    candidates = [p for p in (pa, pb) if p >= 0]
    return min(candidates) if candidates else -1


def extract_subchannel(frames, subchid: int) -> bytes:
    """Concatenate one sub-channel's bytes across frames (eti2mpa's core).

    Frames missing the sub-channel (corrupt STC, NST change during a
    reconfiguration) are skipped, not fatal."""
    return b"".join(f.streams[subchid].data for f in frames
                    if subchid in f.streams)


def read_eti_file(f: BinaryIO, mode=C.MODE_I):
    parser = EtiParser(mode)
    while True:
        chunk = f.read(1 << 20)
        if not chunk:
            return
        yield from parser.feed(chunk)
