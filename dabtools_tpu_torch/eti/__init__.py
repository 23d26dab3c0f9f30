"""ETI(NI) parsing, assembly and EDI framing, and the DAB+ superframe path
(host side)."""
