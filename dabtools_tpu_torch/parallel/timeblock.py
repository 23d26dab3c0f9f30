"""Time-block (sequence) parallel receiver with halo exchange.

Port of ``dabtools_tpu/parallel/timeblock.py`` on the devices of a
:class:`~dabtools_tpu_torch.parallel.mesh.ReceiverMesh`.  The IQ span's
time axis is cut into the mesh's ``time`` shards.  Each shard decodes its
own ``F`` transmission frames plus ``W`` *warmup* frames read from a left
halo: the last samples of its left neighbour (the JAX package's
``ppermute``; here a slice of the span, moved with ``.to`` onto the
shard's device).  The warmup re-primes the 16-CIF time-deinterleaver
locally (W*n_cifs >= 16), turning the only sequential cross-shard
dependency into redundant compute: shards are then independent.

Boundary shards take their halo from explicit ``prefix``/``suffix``
tensors (the streaming host supplies the previous span's tail / next
span's head; zeros at cold start give the usual startup transient).

Every (channel, shard) runs the receiver's :func:`pre_viterbi`; then ONE
ragged Viterbi dispatch per device takes all of their codewords (on one
card: one K1 and one K2 launch per span), then :func:`post_viterbi`.
Nothing inside waits for the device.

Deterministic seams: shard ``i`` emits exactly global frames
``[i*F, (i+1)*F)`` of the span — no duplicates, no gaps, bit-identical to
the JAX package's sharded receiver (tests, 8-device CPU mesh).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.models.receiver import post_viterbi, pre_viterbi
from dabtools_tpu_torch.ops.fec import init_deinterleave_ring
from dabtools_tpu_torch.parallel.channel import decode_by_device
from dabtools_tpu_torch.parallel.mesh import ReceiverMesh


def halo_sizes(warmup_frames: int, mode=C.MODE_I,
               left_margin: int = 256, right_margin: int = 4096):
    """(LH, RH) halo sample counts."""
    return warmup_frames * mode.frame_size + left_margin, right_margin


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
    guesses: dict = {}     # per device: the W+F frame start guesses
    own_cifs = slice(w * mode.n_cifs, None)

    def shard_input(x, prefix, suffix, c, i, dev):
        """Channel ``c``'s shard ``i`` with its halos, on ``dev``."""
        own = x[c, i * f_own * fr:(i + 1) * f_own * fr]
        lctx = (prefix[c] if i == 0
                else x[c, i * f_own * fr - lh: i * f_own * fr])
        rctx = (suffix[c] if i == n_shards - 1
                else x[c, (i + 1) * f_own * fr:(i + 1) * f_own * fr + rh])
        return torch.cat([lctx.to(dev), own.to(dev), rctx.to(dev)])

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
        cells = [(c, i, mesh.devices[rows[c]][i])
                 for c in range(x.shape[0]) for i in range(n_shards)]
        outs, jobs, groups = [], [], {}
        for c, i, dev in cells:
            if dev not in guesses:
                guesses[dev] = left_margin + torch.arange(
                    w + f_own, dtype=torch.int32, device=dev) * fr
            # the CIF count of the scan's first frame, g0 + i*F - W
            cif0 = torch.full((), (int(g0) + i * f_own - w) * mode.n_cifs,
                              dtype=torch.int32, device=dev)
            rings = {str(s.subchid): init_deinterleave_ring(
                s.profile.tx_bits, dev) for s in ensemble.subchannels}
            out, _, job, groups = pre_viterbi(
                shard_input(x, prefix, suffix, c, i, dev), guesses[dev],
                rings, cif0, ensemble=ensemble, mode=mode, search=search,
                max_int_cfo=max_int_cfo)
            outs.append(out)
            jobs.append(job)
        decoded = decode_by_device([dev for _, _, dev in cells], jobs)
        for out, dec in zip(outs, decoded):
            post_viterbi(out, groups, dec, w + f_own, mode)

        home = x.device

        def gather(pick):
            """Each cell's ``pick(out)`` concatenated over the shards of
            its channel, stacked over the channels, on ``home``."""
            return torch.stack([
                torch.cat([pick(outs[c * n_shards + i]).to(home)
                           for i in range(n_shards)])
                for c in range(x.shape[0])])

        keys = [str(s.subchid) for s in ensemble.subchannels]
        return {
            "fib_bytes": gather(lambda o: o["fib_bytes"][w:]),
            "fic_metric": gather(lambda o: o["fic_metric"][w:]),
            "prs_peak": gather(lambda o: o["prs_peak"][w:]),
            "prs_offset": gather(lambda o: o["prs_offset"][w:]),
            "cfo_carriers": gather(lambda o: o["cfo_carriers"][None]),
            "subch": {k: gather(lambda o, k=k: o["subch"][k][own_cifs])
                      for k in keys},
            "subch_metric": {k: gather(
                lambda o, k=k: o["subch_metric"][k][own_cifs])
                for k in keys},
        }

    return run
