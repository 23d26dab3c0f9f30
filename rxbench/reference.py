"""The plain reference: the ETI(NI) frames a receiver must emit, built
from the generator's truth and the configuration alone, and the check
of a receiver's stream against them.

ETI(NI) frame (ETS 300 799 s5), in the layout of the repository's
``docs/INTEROP.md`` rows 7-8:

  ERR(1) FSYNC(3) | FC(4) STC(4 * NST) MNSC(2) CRC(2) |
  MST: FIC (3 FIBs, 96 bytes) + each sub-channel's logical frame in
  start-CU order | CRC(2) RFU(2) | TIST(4) | 0x55 to 6144 bytes.

FC: FCT(8) = frame count mod 250, FICF(1) = 1, NST(7), FP(3) = frame
count mod 8, MID(2) = 1 (Mode I), FL(11) = (STC + EOH + MST) bytes / 4.
STC entry: SCID(6) SAD(10) TPL(6) STL(10), with SAD the sub-channel's
start in the MST in 64-bit words (the FIC's 12 first), STL its length
in 64-bit words (``kbps`` x 3 / 8, for EEP and UEP alike) and TPL, "type
and protection level":

* EEP "EEP-<level><option>": 0b1 + option(3) + level-1(2), that is
  ``0x20 | option << 2 | (level - 1)``, option A 0 and B 1;
* UEP "UEP-<level>": 0b01 + 0(2) + level-1(2), that is
  ``0x10 | (level - 1)``, the level read from the configuration.

Both are how ODR-DabMux, a public ETI multiplexer, is recalled to write
them; the standard's text is not at hand, so this reading stands as
``docs/INTEROP.md`` row 8 does, at K-low.  The port
(``eti/assemble.py::tpl_for_subchannel``) writes the same.  The Table 31
index is no reading: it cannot be represented past 31 (every row from 128
kbit/s up), and a 6-bit field cannot hold the short form's 7 bits (table
switch and index).

The header CRC covers FC, STC and MNSC; the EOF CRC the MST; both are
CRC-16/CCITT (init 0xFFFF, complemented).  ERR is 0xFF for a frame
received without error, FSYNC alternates 0x073AB6 / 0xF8C549 with the
frame count's parity, TIST is 0xFFFFFFFF (not in use).

The stream's frame count starts where its first frame says (FCT and FP
agree on it mod 1000); its first frame names the pool CIF it carries by
its MST.  Every later frame must be the next CIF's, byte for byte.
Imports nothing of the program.
"""

from __future__ import annotations

import binascii

FRAME_BYTES = 6144
FSYNC = (b"\x07\x3a\xb6", b"\xf8\xc5\x49")
FIC_BYTES = 96
KEEP = 8                   # whole frames kept for the report


def crc16(data: bytes) -> int:
    return binascii.crc_hqx(data, 0xFFFF) ^ 0xFFFF


def _tpl(s: dict) -> int:
    """The STC TPL of sub-channel entry ``s`` (the module's note)."""
    kind, prot = s["protection"].split("-")
    if kind == "EEP":
        return 0x20 | ({"A": 0, "B": 1}[prot[1]] << 2) | (int(prot[0]) - 1)
    if kind == "UEP" and prot in ("1", "2", "3", "4", "5"):
        return 0x10 | (int(prot) - 1)
    raise ValueError(f"no TPL for {s}")


class Expected:
    """The frames a receiver of ensemble ``truth.spec`` must emit for the
    pool CIFs of ``truth``."""

    def __init__(self, truth):
        subs = sorted(truth.spec["subchannels"], key=lambda s: s["start_cu"])
        stc, sad = bytearray(), FIC_BYTES // 8
        for s in subs:
            tpl = _tpl(s)
            stl = s["kbps"] * 3 // 8
            stc += bytes([(s["id"] << 2) | (sad >> 8), sad & 0xFF,
                          (tpl << 2) | (stl >> 8), stl & 0xFF])
            sad += stl
        self.stc = bytes(stc)
        self.nst = len(subs)
        self.n = len(truth.fic)
        self.mst = [truth.fic[j] + b"".join(
            truth.payload[s["id"]][j].tobytes() for s in subs)
            for j in range(self.n)]
        self.fl = (4 * self.nst + 4 + len(self.mst[0])) // 4
        self.eof = [crc16(m).to_bytes(2, "big") + b"\xff\xff"
                    for m in self.mst]
        self.index = {m: j for j, m in enumerate(self.mst)}
        self._heads: dict[int, bytes] = {}

    def head(self, count: int) -> bytes:
        """ERR, FSYNC, FC, STC and EOH of frame ``count``."""
        c = count % 1000
        h = self._heads.get(c)
        if h is None:
            fct, fp = c % 250, c % 8
            hdr = bytes([fct, 0x80 | self.nst,
                         (fp << 5) | (1 << 3) | (self.fl >> 8),
                         self.fl & 0xFF]) + self.stc + b"\xff\xff"
            h = b"\xff" + FSYNC[c % 2] + hdr + crc16(hdr).to_bytes(2, "big")
            self._heads[c] = h
        return h

    def frame(self, j: int, count: int) -> bytes:
        body = (self.head(count) + self.mst[j] + self.eof[j]
                + b"\xff\xff\xff\xff")
        return body + b"\x55" * (FRAME_BYTES - len(body))

    def locate(self, frame: bytes):
        """(pool CIF, frame count) that ``frame`` claims, or None."""
        start = 12 + 4 * self.nst
        j = self.index.get(frame[start: start + len(self.mst[0])])
        fct, fp = frame[4], frame[6] >> 5
        count = next((c for c in range(fct, 1000, 250) if c % 8 == fp),
                     None)
        return None if j is None or count is None else (j, count)


class StreamCheck:
    """One receiver's ETI stream: kept as a hash per frame while the
    window runs, and held against :class:`Expected` after it."""

    def __init__(self, truth):
        self.truth = truth
        self.hashes: list[int] = []
        self.kept: list[bytes] = []

    @property
    def count(self) -> int:
        return len(self.hashes)

    def add(self, frames: list) -> None:
        if len(self.kept) < KEEP:
            self.kept.extend(frames[: KEEP - len(self.kept)])
        self.hashes.extend(map(hash, frames))

    def bad_frames(self) -> tuple[int, str]:
        """(frames that differ from the reference, a line on the first)."""
        if self.truth.spec is None:
            return self.count, (f"{self.count} frames from a block with no "
                                f"ensemble" if self.count else "")
        if not self.count:
            return 0, ""
        ref = Expected(self.truth)
        at = ref.locate(self.kept[0])
        if at is None:
            return self.count, "the first frame carries no pool CIF"
        j0, c0 = at
        bad, first = 0, ""
        for k, h in enumerate(self.hashes):
            want = ref.frame((j0 + k) % ref.n, c0 + k)
            if hash(want) != h:
                bad += 1
                if not first:
                    first = f"frame {k} (pool CIF {(j0 + k) % ref.n})"
                    if k < len(self.kept):
                        first += ", " + _diff(self.kept[k], want)
        return bad, first


def _diff(got: bytes, want: bytes) -> str:
    if len(got) != len(want):
        return f"{len(got)} bytes for {len(want)}"
    off = next(i for i in range(len(want)) if got[i] != want[i])
    return f"first differing byte {off}: {got[off]:#04x} for {want[off]:#04x}"
