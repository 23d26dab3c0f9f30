"""L0 hardware frontends (SURVEY.md s1: `upstream:dab2eti.c` R2).

Only the RTL-SDR path is implemented; the Psion WaveFinder (R3) is out of
scope (discontinued USB hardware whose value was doing OFDM demod in
hardware — the TPU does it better in software)."""
