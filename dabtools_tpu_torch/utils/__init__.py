"""Host utilities: CRCs, energy-dispersal PRBS, GF(256), the native library."""
