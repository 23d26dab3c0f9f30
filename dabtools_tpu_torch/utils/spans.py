"""Host spans at the port's layer boundaries, on ``time.perf_counter_ns``.

Process-global and off by default.  Off, :func:`span` tests one flag and
returns one shared no-op object: nothing is allocated and no clock is
read.  On, every span records ``(name, t0, t1, parent, nbytes)``:

* ``t0``, ``t1``: ``time.perf_counter_ns`` at entry and exit;
* ``parent``: the index, in the same list, of the span that was open
  around it (None for a root), so the spans of one ``feed`` or one
  front-end call share a root;
* ``nbytes``: the bytes a copy span moves (0 elsewhere).

Spans are host-side only: no profiler annotation (a ``torch.profiler``
trace would list one as device work), no device op, and no host sync
while tracing is off.  :func:`download` is the one place where tracing
on changes what runs: it waits for the stream before the copy, so that
the wait and the copy come apart.

    from dabtools_tpu_torch.utils import spans
    spans.enable()
    rx.feed(block)
    for name, t0, t1, parent, nbytes in spans.drain(): ...

:func:`drain` is called between calls, with no span open.
"""

from __future__ import annotations

import time

import numpy as np

_clock = time.perf_counter_ns
_on = False
_spans: list[tuple] = []
_open: list[int] = []          # indices of the open spans, innermost last


class _Span:
    __slots__ = ("name", "nbytes", "i")

    def __init__(self, name: str, nbytes: int):
        self.name = name
        self.nbytes = nbytes

    def __enter__(self):
        self.i = len(_spans)
        _spans.append((self.name, _clock(), 0,
                       _open[-1] if _open else None, self.nbytes))
        _open.append(self.i)
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        _open.pop()
        name, t0, _, parent, nbytes = _spans[self.i]
        _spans[self.i] = (name, t0, t1, parent, nbytes)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NO_SPAN = _NoSpan()


def span(name: str, nbytes: int = 0):
    """A context manager that records ``name`` while tracing is on."""
    if not _on:
        return _NO_SPAN
    return _Span(name, nbytes)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> list[tuple]:
    """The spans recorded so far, in the order they opened; clears them."""
    out = list(_spans)
    _spans.clear()
    _open.clear()
    return out


def download(t, wait: str, copy: str) -> np.ndarray:
    """``t.cpu().numpy()``.  With tracing on, a stream sync first, in
    span ``wait``, then the copy alone in span ``copy``."""
    if not _on:
        return t.cpu().numpy()
    with _Span(wait, 0):
        if t.is_cuda:
            import torch
            torch.cuda.current_stream(t.device).synchronize()
    with _Span(copy, t.numel() * t.element_size()):
        return t.cpu().numpy()


def self_ns(spans: list[tuple]) -> dict[str, int]:
    """Each name's self time in ns: its spans' durations less the
    durations of their children."""
    out: dict[str, int] = {}
    for name, t0, t1, parent, _ in spans:
        out[name] = out.get(name, 0) + t1 - t0
        if parent is not None:
            p = spans[parent][0]
            out[p] = out.get(p, 0) - (t1 - t0)
    return out
