"""DAB transmission-mode numerology (ETSI EN 300 401, Table 38).

The reference (linuxstb/dabtools, `upstream:input_sdr.c` / `upstream:dab.c`)
hard-codes Mode I constants inline; here they live in one table so every
stage (modulator, sync, OFDM demod, FEC sizing, ETI assembly) derives its
static shapes from a single source of truth.  All shapes downstream of this
module are Python ints at trace time -> XLA sees only static shapes.

Mode I is the fully-supported mode (as in the reference, which targets
Band III terrestrial DAB).  Modes II-IV numerology is defined for
completeness and for the generalized frequency-interleaver rule.
"""

from __future__ import annotations

import dataclasses

SAMPLE_RATE = 2_048_000  # complex samples/s at baseband (all modes)


@dataclasses.dataclass(frozen=True)
class Mode:
    """Numerology for one DAB transmission mode (EN 300 401 Table 38)."""

    name: str
    fft_size: int          # T_u, useful-symbol samples (= FFT length)
    guard: int             # T_g, guard-interval samples (cyclic prefix)
    null_size: int         # T_null, null-symbol samples
    n_symbols: int         # OFDM symbols per transmission frame (incl. PRS)
    n_carriers: int        # K, active carriers
    n_cifs: int            # CIFs per transmission frame
    n_fibs: int            # FIBs per transmission frame
    n_fic_syms: int        # OFDM symbols carrying the FIC

    @property
    def symbol_size(self) -> int:       # T_s = T_u + guard
        return self.fft_size + self.guard

    @property
    def frame_size(self) -> int:        # T_f in samples
        return self.null_size + self.n_symbols * self.symbol_size

    @property
    def frame_duration_s(self) -> float:
        return self.frame_size / SAMPLE_RATE

    @property
    def bits_per_symbol(self) -> int:   # DQPSK: 2 bits per carrier
        return 2 * self.n_carriers

    @property
    def n_msc_syms(self) -> int:        # data symbols after PRS + FIC
        return self.n_symbols - 1 - self.n_fic_syms

    @property
    def fic_bits_per_frame(self) -> int:
        return self.n_fic_syms * self.bits_per_symbol

    @property
    def msc_bits_per_frame(self) -> int:
        return self.n_msc_syms * self.bits_per_symbol

    @property
    def fic_codewords_per_frame(self) -> int:
        # Each punctured FIC codeword is 2304 bits (EN 300 401 s11.2).
        # In Mode III codewords span frames (4 FIBs/frame, 3/codeword);
        # use block-level counts there (see models/receiver.py).
        if self.fic_bits_per_frame % FIC_PUNCTURED_BITS:
            raise ValueError(
                f"Mode {self.name}: FIC codewords span frames")
        return self.fic_bits_per_frame // FIC_PUNCTURED_BITS


MODE_I = Mode("I", fft_size=2048, guard=504, null_size=2656,
              n_symbols=76, n_carriers=1536, n_cifs=4, n_fibs=12,
              n_fic_syms=3)
MODE_II = Mode("II", fft_size=512, guard=126, null_size=664,
               n_symbols=76, n_carriers=384, n_cifs=1, n_fibs=3,
               n_fic_syms=3)
MODE_III = Mode("III", fft_size=256, guard=63, null_size=345,
                n_symbols=153, n_carriers=192, n_cifs=1, n_fibs=4,
                n_fic_syms=8)
MODE_IV = Mode("IV", fft_size=1024, guard=252, null_size=1328,
               n_symbols=76, n_carriers=768, n_cifs=2, n_fibs=6,
               n_fic_syms=3)

MODES = {m.name: m for m in (MODE_I, MODE_II, MODE_III, MODE_IV)}

# ---------------------------------------------------------------- CIF / MSC
CU_BITS = 64                 # one Capacity Unit = 64 bits
CIF_CUS = 864                # CUs per Common Interleaved Frame
CIF_BITS = CU_BITS * CIF_CUS  # 55296
CIF_DURATION_S = 0.024       # one CIF == one 24 ms logical frame

# ---------------------------------------------------------------- FIC / FIB
FIB_BITS = 256               # one Fast Information Block
FIB_BYTES = 32               # 30 data + 2 CRC
FIBS_PER_CODEWORD = 3        # one FIC codeword protects a FIB triplet
FIC_INFO_BITS = FIBS_PER_CODEWORD * FIB_BITS          # 768
FIC_TAIL_BITS = 6
FIC_MOTHER_BITS = 4 * (FIC_INFO_BITS + FIC_TAIL_BITS)  # 3096
FIC_PUNCTURED_BITS = 2304    # after PI=16/PI=15/VT puncturing

# ---------------------------------------------------------------- conv code
CONV_K = 7                   # constraint length
CONV_STATES = 64
# Generator polynomials, octal (EN 300 401 s11.1.1):
#   g1 = 1+D^2+D^3+D^5+D^6, g2 = 1+D+D^2+D^3+D^6, g3 = 1+D+D^4+D^6, g4 = g1
CONV_POLYS = (0o133, 0o171, 0o145, 0o133)
CONV_RATE_DEN = 4            # rate-1/4 mother code
TAIL_BITS = 6                # zero tail flushes the encoder

# ---------------------------------------------------------------- ETI(NI)
ETI_FRAME_BYTES = 6144       # per 24 ms (ETS 300 799)
ETI_FRAME_DURATION_S = 0.024
ETI_FSYNC = 0x073AB6         # FSYNC word; complemented on alternate frames
ETI_FSYNC_INV = 0xF8C549

# ---------------------------------------------------------------- DAB+
RS_N = 120                   # RS(120,110) over GF(2^8), shortened RS(255,245)
RS_K = 110
RS_T = 5
GF_POLY = 0x11D              # field generator x^8+x^4+x^3+x^2+1
SUPERFRAME_FRAMES = 5        # audio superframe spans 5 logical frames
FIRECODE_POLY = 0x782F       # x^16+x^14+x^13+x^12+x^11+x^5+x^3+x^2+x+1

# Time interleaving (EN 300 401 s12): bit i of a sub-channel CIF is delayed
# by bitrev4(i mod 16) logical frames at the transmitter.
TIME_INTERLEAVE_DEPTH = 16
