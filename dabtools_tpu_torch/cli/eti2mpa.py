"""``eti2mpa``: exact interface parity with the reference tool
(`upstream:eti2mpa.c`): ETI(NI) in, MPEG-1 Layer II elementary stream out.

This is a thin alias for ``eti2audio`` restricted to the MP2 path; use
``eti2audio`` for DAB+ services.
"""

from __future__ import annotations

import sys

from dabtools_tpu_torch.cli.eti2audio import main as _main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return _main(argv)


if __name__ == "__main__":
    sys.exit(main())
