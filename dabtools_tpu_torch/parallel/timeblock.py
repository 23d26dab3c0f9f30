"""Time-block (sequence) parallel receiver with halo exchange.

Port of ``dabtools_tpu/parallel/timeblock.py`` on the devices of a
:class:`~dabtools_tpu_torch.parallel.mesh.ReceiverMesh`.  The IQ span's
time axis is cut into the mesh's ``time`` shards.  Each shard decodes its
own ``F`` transmission frames plus ``W`` *warmup* frames read from a left
halo: the last samples of its left neighbour (the JAX package's
``ppermute``).  Between cells of one process a halo is a slice of the
span, moved with ``.to`` onto the shard's device; between cells of two
processes it is sent (:func:`exchange_halos`).  The warmup re-primes
the 16-CIF time-deinterleaver locally (W*n_cifs >= 16), turning the only
sequential cross-shard dependency into redundant compute: shards are
then independent.

Boundary shards take their halo from explicit ``prefix``/``suffix``
tensors (the streaming host supplies the previous span's tail / next
span's head; zeros at cold start give the usual startup transient).

The (channel, shard) cells of this process that share a device run as
one batch (the JAX package's vmap over a shard's channels, here over
every cell of the device): ONE :func:`pre_viterbi` over a leading cells
axis, each cell with its own halo-extended samples and CIF count, then
ONE ragged Viterbi dispatch for all of their codewords (on one card: one
K1 and one K2 launch per span and process), then ONE
:func:`post_viterbi`.  In one process nothing inside waits for the
device; a halo sent through ``gloo`` is copied to the host.

Deterministic seams: shard ``i`` emits exactly global frames
``[i*F, (i+1)*F)`` of the span — no duplicates, no gaps, bit-identical to
the JAX package's sharded receiver (tests, 8-device CPU mesh).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.models.receiver import pick_stream, pipeline_core
from dabtools_tpu_torch.parallel.mesh import ReceiverMesh, assemble_cells


def halo_sizes(warmup_frames: int, mode=C.MODE_I,
               left_margin: int = 256, right_margin: int = 4096):
    """(LH, RH) halo sample counts."""
    return warmup_frames * mode.frame_size + left_margin, right_margin


def _transport(dev: torch.device) -> torch.device:
    """Where a halo between processes travels, by the group's backend:
    host memory for ``gloo``, the cell's CUDA device for ``nccl``."""
    backend = dist.get_backend()
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        return dev
    raise ValueError(f"no halo transport for backend {backend!r} (gloo or "
                     f"nccl)")


def exchange_halos(mesh: ReceiverMesh, x, prefix, suffix, shard_len: int,
                   lh: int, rh: int) -> dict:
    """The halos of this process's cells of a span.

    ``x``, ``prefix``, ``suffix``: as :func:`timeblock_receiver`'s
    ``fn`` takes them; only the samples of this rank's cells (and the
    prefix/suffix of its boundary cells) are read.  Returns
    ``{(channel, shard): (left, right)}`` for the cells this rank owns,
    channel-major, each halo on its cell's device: ``lh`` samples before
    the shard and ``rh`` after it.  A halo whose neighbour cell is this
    rank's is a slice of ``x``; one whose neighbour is another rank's is
    sent by that rank, every send and receive of the span in one
    ``batch_isend_irecv``, in an order every rank derives from the mesh.
    """
    rank = mesh.process_rank()
    rows = mesh.rows_of(x.shape[0])
    n_shards = mesh.shape["time"]

    def owner(c, i):
        return mesh.ranks[rows[c]][i]

    def device(c, i):
        return mesh.devices[rows[c]][i]

    ops, received = [], {}
    for c in range(x.shape[0]):
        for i in range(1, n_shards):
            if owner(c, i - 1) == owner(c, i):
                continue
            o = i * shard_len
            for tag, (src, dst, side, lo, hi) in enumerate(
                    (((c, i - 1), (c, i), "left", o - lh, o),
                     ((c, i), (c, i - 1), "right", o, o + rh)),
                    start=2 * (c * n_shards + i)):
                if owner(*src) == rank:
                    buf = x[c, lo:hi].to(_transport(device(*src)))
                    ops.append(dist.P2POp(dist.isend, buf.contiguous(),
                                          owner(*dst), tag=tag))
                elif owner(*dst) == rank:
                    buf = torch.empty(hi - lo, dtype=x.dtype,
                                      device=_transport(device(*dst)))
                    ops.append(dist.P2POp(dist.irecv, buf, owner(*src),
                                          tag=tag))
                    received[dst, side] = buf
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    halos = {}
    for c in range(x.shape[0]):
        for i in range(n_shards):
            if owner(c, i) != rank:
                continue
            o, e = i * shard_len, (i + 1) * shard_len
            if i == 0:
                left = prefix[c]
            elif owner(c, i - 1) == rank:
                left = x[c, o - lh:o]
            else:
                left = received[(c, i), "left"]
            if i == n_shards - 1:
                right = suffix[c]
            elif owner(c, i + 1) == rank:
                right = x[c, e:e + rh]
            else:
                right = received[(c, i), "right"]
            halos[c, i] = left.to(device(c, i)), right.to(device(c, i))
    return halos


def timeblock_receiver(mesh: ReceiverMesh, ensemble: Ensemble,
                       mode=C.MODE_I, frames_per_shard: int = 4,
                       warmup_frames: int = 5, search: int = 192,
                       max_int_cfo: int = 8, left_margin: int = 256,
                       right_margin: int = 4096):
    """Build the sharded span decoder.

    Returns ``fn(x, prefix, suffix, g0) -> out`` where
      * ``x``: (n_channels, n_shards*F*frame_size) complex64 tensor,
        frame-aligned (sample 0 is a null-symbol start in steady state);
        the channels split over the mesh's channel rows;
      * ``prefix``: (n_channels, LH) samples preceding the span;
      * ``suffix``: (n_channels, RH) samples following it;
      * ``g0``: global frame index (an int) of the span's first frame;
      * ``out`` (on ``x``'s device): fib_bytes (C, n_shards*F, 12, 32),
        subch[id] (C, n_shards*F*n_cifs, data_bytes), metrics,
        diagnostics; shards concatenated on the time axis.

    On a mesh whose cells span processes, every rank calls ``fn`` with
    the same global shapes; it decodes this rank's cells only, reads
    only their samples, and returns ``{(channel, shard): cell dict}`` on
    the cells' devices (each leaf the cell's part of ``out``'s time
    axis); :func:`~dabtools_tpu_torch.parallel.mesh.gather_span` makes
    ``out`` of them on every rank.
    """
    n_shards = mesh.shape["time"]
    fr = mode.frame_size
    f_own = frames_per_shard
    w = warmup_frames
    if w * mode.n_cifs < C.TIME_INTERLEAVE_DEPTH:
        raise ValueError(
            f"warmup_frames={w} gives {w * mode.n_cifs} CIFs < "
            f"{C.TIME_INTERLEAVE_DEPTH} needed to prime the deinterleaver")
    # Mode III FIC codewords span 3 frames: every shard's scan must start
    # on a codeword boundary (global frame multiple of 3), so shard spans
    # and warmup must preserve that phase (and g0 must be a multiple of 3).
    fic_span = 1
    if mode.fic_bits_per_frame % C.FIC_PUNCTURED_BITS:
        fic_span = C.FIC_PUNCTURED_BITS // math.gcd(
            mode.fic_bits_per_frame, C.FIC_PUNCTURED_BITS)
        if f_own % fic_span or w % fic_span:
            raise ValueError(
                f"Mode {mode.name}: frames_per_shard={f_own} and "
                f"warmup_frames={w} must be multiples of {fic_span} "
                f"(FIC codewords span {fic_span} frames)")
    lh, rh = halo_sizes(w, mode, left_margin, right_margin)
    if max(lh, rh) > f_own * fr:
        raise ValueError(
            f"halo ({lh} samples) exceeds the shard span "
            f"({f_own} frames = {f_own * fr}); single-hop ppermute halo "
            f"exchange requires frames_per_shard > warmup_frames")
    # per (device, its cells): the W+F frame start guesses and each
    # cell's shard offset in CIFs, made once
    per_device: dict = {}
    own_cifs = slice(w * mode.n_cifs, None)
    keys = [str(s.subchid) for s in ensemble.subchannels]

    def own_frames(o):
        """A cell's output without its W warmup frames."""
        return {
            "fib_bytes": o["fib_bytes"][w:],
            "fic_metric": o["fic_metric"][w:],
            "prs_peak": o["prs_peak"][w:],
            "prs_offset": o["prs_offset"][w:],
            "cfo_carriers": o["cfo_carriers"][None],
            "subch": {k: o["subch"][k][own_cifs] for k in keys},
            "subch_metric": {k: o["subch_metric"][k][own_cifs]
                             for k in keys},
        }

    def run(x, prefix, suffix, g0):
        # The third leg of the Mode III codeword-phase invariant: g0
        # itself must sit on a codeword boundary (the other two are
        # checked at construction above), where g0 is a concrete int.
        if (fic_span > 1 and isinstance(g0, (int, np.integer))
                and int(g0) % fic_span):
            raise ValueError(
                f"Mode {mode.name}: g0={g0} must be a multiple of "
                f"{fic_span} (FIC codewords span {fic_span} frames)")
        expect = n_shards * f_own * fr
        if x.shape[-1] != expect:
            raise ValueError(
                f"span must be {expect} samples "
                f"({n_shards} shards x {f_own} frames), got {x.shape[-1]}")
        if prefix.shape[-1] != lh or suffix.shape[-1] != rh:
            raise ValueError(
                f"prefix/suffix must be {lh}/{rh} samples, got "
                f"{prefix.shape[-1]}/{suffix.shape[-1]}")
        rows = mesh.rows_of(x.shape[0])
        halos = exchange_halos(mesh, x, prefix, suffix, f_own * fr, lh, rh)
        by_dev: dict = {}
        for c, i in halos:
            by_dev.setdefault(mesh.devices[rows[c]][i], []).append((c, i))
        mine = {}
        for dev, cells in by_dev.items():
            if (dev, tuple(cells)) not in per_device:
                per_device[dev, tuple(cells)] = (
                    left_margin + torch.arange(
                        w + f_own, dtype=torch.int32, device=dev) * fr,
                    torch.tensor([i * f_own * mode.n_cifs for _, i in cells],
                                 dtype=torch.int32, device=dev))
            g, shard_cifs = per_device[dev, tuple(cells)]
            # each cell's [left halo | own samples | right halo], one row
            xe = torch.cat([
                t for c, i in cells for t in (
                    halos[c, i][0],
                    x[c, i * f_own * fr:(i + 1) * f_own * fr].to(dev),
                    halos[c, i][1])]).reshape(len(cells), -1)
            # the CIF count of each cell's first frame, g0 + i*F - W
            cif0 = shard_cifs + (int(g0) - w) * mode.n_cifs
            rings = {str(s.subchid): torch.zeros(
                (len(cells), C.TIME_INTERLEAVE_DEPTH, s.profile.tx_bits),
                device=dev) for s in ensemble.subchannels}
            out, _, _ = pipeline_core(
                xe, g.expand(len(cells), -1), rings, cif0,
                ensemble=ensemble, mode=mode, search=search,
                max_int_cfo=max_int_cfo)
            mine.update({cell: own_frames(pick_stream(out, k))
                         for k, cell in enumerate(cells)})
        if len(mine) < x.shape[0] * n_shards:
            return mine
        return assemble_cells(mine, x.device)

    return run
