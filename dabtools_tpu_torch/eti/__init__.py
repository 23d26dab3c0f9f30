"""ETI(NI) parsing, assembly and EDI framing (host side)."""
