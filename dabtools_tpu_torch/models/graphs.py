"""The receiver's device chain as CUDA graphs: one capture per chain key,
then a replay per block.

``process_block`` launches a block's chain, ~400 small device operations
(629 for a 17-sub-channel multiplex), one at a time from Python.  A
:class:`ChainGraphs`, one per receiver, captures that chain and then
launches it as one graph a block:

* The key (:func:`chain_key`) is all that shapes the chain: the input's
  dtype, shape and device, and every keyword of the chain (the decode
  configuration or None for the FIC-only pass, mode, ``n_frames``, the
  sync search, ``tii``, the probe sub-channels).
* The first block under a key runs op by op.  That warms every table the
  chain caches per device, so nothing is uploaded during a capture.  The
  second block captures, and every later block replays.  A new key drops
  the old key's graphs, so memory does not grow with reconfigurations.
* State.  The block's input is copied into a static tensor: one
  device-to-device copy.  The rings and the CIF counter live in two
  static sets, A and B: one graph reads A and writes B, the other reads B
  and writes A, so the rings a block was given are intact after it.  The
  B->A graph ends with a copy of its new state into A: one kernel for
  the rings, one copy for the counter.
  Where the rings or the counter passed in are not the set a graph reads
  (checked by identity), they are copied into A first: the first replay,
  a restore, a new ring, a caller that hands back old rings.
* Outputs are the graph's own tensors, valid until the next call on the
  same cache.
* ``cudalib.launches`` counts in Python: a capture counts the chain's
  launches twice (the two recordings), a replay not at all.  What a
  replay ran on the device shows in a device trace.

Off a CUDA device every call runs op by op.  ``counts`` tallies the
passes: ``eager``, ``captures`` (the block that captures, then replays)
and ``replays``.  Span ``enqueue.graph``: a replay, with its input copy
and any copy into set A.
"""

from __future__ import annotations

import collections

import torch

from dabtools_tpu_torch.utils import spans


def chain_key(x: torch.Tensor, **chain_kw) -> tuple:
    """What shapes the chain for input ``x`` and the chain's keywords;
    equal keys run the same operations on tensors of the same shapes."""
    return (x.dtype, tuple(x.shape), x.device,
            tuple(sorted(chain_kw.items(), key=lambda kv: kv[0])))


class ChainGraphs:
    """A receiver's captured chain: the live key's two graphs and their
    static state.  Called as ``graphs(chain, x, rings, cif_count,
    **chain_kw)``, it returns ``chain``'s ``(out, rings', cif_count')``."""

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()
        self.key = None
        self._x = None          # the static input
        self._sets = None       # [A, B], each (rings, cif_count)
        self._graphs = None     # by the set read: (graph, out)

    def __call__(self, chain, x, rings, cif_count, **chain_kw):
        key = chain_key(x, **chain_kw)
        if not x.is_cuda or key != self.key:
            # a new key: the old key's graphs and state go
            self._x = self._sets = self._graphs = None
            self.key = key if x.is_cuda else None
            self.counts["eager"] += 1
            return chain(x, rings, cif_count, **chain_kw)
        with torch.cuda.device(x.device):
            if self._graphs is None:
                self._capture(chain, x, rings, cif_count, chain_kw)
                self.counts["captures"] += 1
            else:
                self.counts["replays"] += 1
            with spans.span("enqueue.graph"):
                return self._replay(x, rings, cif_count)

    def _capture(self, chain, x, rings, cif_count, chain_kw) -> None:
        """Record the A->B and the B->A graph; run neither."""
        self._x = torch.empty_like(x)
        a = ({k: r.clone() for k, r in rings.items()}, cif_count.clone())
        pool = torch.cuda.graph_pool_handle()
        ab = torch.cuda.CUDAGraph()
        with torch.cuda.graph(ab, pool=pool):
            out_ab, *b = chain(self._x, *a, **chain_kw)
        a = ({k: a[0][k] for k in b[0]}, a[1])
        ba = torch.cuda.CUDAGraph()
        with torch.cuda.graph(ba, pool=pool):
            out_ba, rings_ba, cif_ba = chain(self._x, *b, **chain_kw)
            if a[0]:
                torch._foreach_copy_(list(a[0].values()),
                                     [rings_ba[k] for k in a[0]])
            a[1].copy_(cif_ba)
        self._sets = [a, tuple(b)]
        self._graphs = [(ab, out_ab), (ba, out_ba)]

    def _reads(self, rings: dict, cif_count: torch.Tensor) -> int:
        """The set (0 for A, 1 for B) that is ``rings`` and ``cif_count``;
        where neither is, they are copied into A."""
        for i, (r, c) in enumerate(self._sets):
            if c is cif_count and all(rings.get(k) is t
                                      for k, t in r.items()):
                return i
        r, c = self._sets[0]
        for k, t in r.items():
            if rings[k] is not t:
                t.copy_(rings[k])
        if cif_count is not c:
            c.copy_(cif_count)
        return 0

    def _replay(self, x, rings, cif_count):
        self._x.copy_(x)
        i = self._reads(rings, cif_count)
        graph, out = self._graphs[i]
        graph.replay()
        new_rings, new_cif = self._sets[1 - i]
        return out, dict(new_rings), new_cif
