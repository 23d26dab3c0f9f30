"""End-to-end DAB receiver: IQ blocks -> decoded FIC/MSC -> ETI (dab2eti).

Port of ``dabtools_tpu/models/receiver.py``.

* The device step processes a *block* of ``n_frames`` transmission frames
  per call, on one explicit device, and sends its whole output to the
  host in ONE device->host copy.
* Sync is data, not control flow: coarse null position, per-frame PRS
  fine offsets and CFO are tensors feeding the gathers; ``pipeline_core``
  never reads a value back to the host.
* FIC and every MSC profile group decode in ONE ragged Viterbi dispatch
  (the hand-written K1/K2 kernels on a CUDA device).
* The demod chain is written once for a leading stream axis (the JAX
  package's vmap, made explicit): a channel batch or a time-block span
  runs it once per device, and a single stream is the chain with no
  such axis.
* All bit-level control (FIG parse, ETI bytes) stays on the host.
* Cross-block receiver state (time-deinterleaver rings, CIF counter)
  stays on the device between blocks; it is also the checkpoint payload,
  in the JAX package's format, so a checkpoint resumes in either package.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.eti.assemble import EtiAssembler
from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.fic.fig import FigParser
from dabtools_tpu_torch.models.graphs import ChainGraphs
from dabtools_tpu_torch.ops.bits import pack_bits
from dabtools_tpu_torch.ops.fec import (
    depuncture,
    descramble,
    init_deinterleave_ring,
    time_deinterleave,
)
from dabtools_tpu_torch.ops.ofdm import demod_frames
from dabtools_tpu_torch.ops.sync import (
    SNR_CAVEAT,
    SNR_METHOD,
    channel_impulse_response,
    coarse_null_sync,
    fine_sync_prs,
    fractional_cfo,
    null_ratio_to_snr_db,
)
from dabtools_tpu_torch.ops.tii import solve_tii, tii_powers_at
from dabtools_tpu_torch.ops.viterbi import viterbi_decode_ragged
from dabtools_tpu_torch.tables.puncturing import FIC_PROFILE
from dabtools_tpu_torch.utils import spans
from dabtools_tpu_torch.utils.crc import crc16_ok_batch

log = logging.getLogger("dabtools_tpu_torch.receiver")


def _length(chunk) -> int:
    """Elements of a buffered input chunk, NumPy array or tensor."""
    return chunk.numel() if torch.is_tensor(chunk) else chunk.size


def block_samples(n_frames: int, mode=C.MODE_I, margin: int = 4096) -> int:
    """Samples the device block function expects per call: ``n_frames``
    frames + one frame of coarse-sync slack + fine-sync margins."""
    return (n_frames + 1) * mode.frame_size + margin


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median along the last axis as ``jnp.median``: the mean of the two
    middle values for an even count (``torch.median`` returns the lower
    one)."""
    s = torch.sort(v, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    return (s[..., n // 2 - 1] + s[..., n // 2]) / 2


def pre_viterbi(x, frame_start_guesses, rings, cif_count, *,
                ensemble: Ensemble | None, mode=C.MODE_I,
                search: int = 192, max_int_cfo: int = 8,
                sync_diag: dict | None = None, probe_subs: tuple = ()):
    """The demod chain up to the Viterbi, from per-frame start *guesses*,
    for one stream or for a leading axis of B streams in the same ops.

    ``x``: (n,) complex64 block, or (B, n) for B streams;
    ``frame_start_guesses``: (n_frames,) integer tensor, start of each
    frame's null symbol, refined per frame by PRS fine sync, or (B,
    n_frames); ``rings``: {subchid str: (16, n_bits) tensor}, or (B, 16,
    n_bits); ``cif_count``: 0-dim int32 tensor, or (B,) (one per stream).
    All on one device; nothing here reads a value back to the host.
    Each stream's sync, CFO, drift and rings are its own.  Returns
    ``(out, rings', jobs, groups)``: the block's diagnostics so far and
    the advanced rings (each leaf with the leading (B,) of ``x``), the
    depunctured codeword batches (FIC first, then one per puncturing
    profile), each with the streams flattened stream-major into its
    lanes, and the sub-channels of each profile, which
    :func:`post_viterbi` needs.
    """
    lead = x.shape[:-1]
    n_frames = frame_start_guesses.shape[-1]
    frac = fractional_cfo(x, frame_start_guesses[..., 0], mode)

    prs_guess = frame_start_guesses.to(torch.int64) + mode.null_size \
        + mode.guard
    # frac is derotated inside the PRS search so the integer-CFO bin and
    # the fractional estimate can never pair inconsistently.
    fine = fine_sync_prs(x, prs_guess, mode, search, max_int_cfo,
                         frac_cfo=frac)
    frame_starts = frame_start_guesses.to(torch.int32) + fine["offset"]
    # frame 0's integer CFO, per stream
    cfo = frac + fine["int_cfo"][..., 0].to(torch.float32)

    # Sample-clock drift (samples/frame) from consecutive PRS fine offsets;
    # median makes it robust to one bad correlation.
    if n_frames > 1:
        spacing = torch.diff(frame_starts, dim=-1).to(torch.float32)
        drift = _median(spacing) - mode.frame_size
    else:
        drift = torch.zeros(lead, dtype=torch.float32, device=x.device)

    soft, diag = demod_frames(x, frame_starts, mode, cfo, drift)

    # ---- Channel impulse response (PRS LS estimate; SFN analysis) ------
    # |h|^2 windowed to lags [-guard, +guard) around the timing reference;
    # RMS delay spread over taps within 20 dB of the strongest path.
    prs_u = frame_starts + mode.null_size + mode.guard
    cir = channel_impulse_response(x, prs_u, cfo, mode)
    half = mode.fft_size // 2
    pw = cir[..., half - mode.guard: half + mode.guard].abs() ** 2
    mask = pw > pw.amax(dim=-1, keepdim=True) * 1e-2
    lags = torch.arange(-mode.guard, mode.guard, dtype=torch.float32,
                        device=x.device)
    e = torch.sum(pw * mask, -1) + 1e-20
    tbar = torch.sum(pw * mask * lags, -1) / e
    delay_spread = torch.sqrt(
        torch.sum(pw * mask * (lags - tbar[..., None]) ** 2, -1) / e)

    # ---- FIC ----------------------------------------------------------
    # Codewords protect FIB triplets; in Mode III they span frames
    # (4 FIBs/frame), so slice the block's whole FIC bit stream.
    total_fic = n_frames * mode.fic_bits_per_frame
    if total_fic % C.FIC_PUNCTURED_BITS:
        raise ValueError(
            f"{n_frames} frames of Mode {mode.name} FIC do not hold whole "
            f"codewords; use a multiple-of-3 block size")
    # every stream's codewords, stream-major in the lanes
    fic_soft = soft[..., : mode.n_fic_syms, :].reshape(
        -1, C.FIC_PUNCTURED_BITS)

    out = {
        "cfo_carriers": cfo,
        "prs_peak": fine["peak"],
        "prs_offset": fine["offset"],
        "carrier_mag_cv": diag["carrier_mag_cv"],
        "cir_power": pw.mean(dim=-2),          # (..., 2*guard) lag window
        "delay_spread": delay_spread,          # (..., n_frames) samples RMS
        "subch": {},
        "subch_metric": {},
        "probe_soft": {},
    }
    if sync_diag:
        out.update(sync_diag)

    # ---- MSC ----------------------------------------------------------
    # Sub-channels sharing a puncturing profile are deinterleaved and
    # depunctured as ONE batch; FIC + every profile group then decode in
    # a SINGLE ragged Viterbi dispatch.  Rings stay per sub-channel.
    new_rings = {}
    if ensemble is not None or probe_subs:
        n_cifs = n_frames * mode.n_cifs
        msc = soft[..., mode.n_fic_syms:, :].reshape(*lead, n_cifs,
                                                     C.CIF_BITS)
    # Sub-channels with an unidentified UEP puncturing row can't be
    # decoded yet, but their CU slice and 16-CIF time deinterleave need
    # only the Table 31 size: the aligned soft rows feed ops.uep_probe's
    # row identification on the host.
    # Spans (host time only): ``demod.deinterleave`` per sub-channel's
    # time deinterleave, ``demod.depuncture`` per Viterbi job (the FIC,
    # then each profile group with its ``cat``).
    for s in probe_subs:
        key = str(s.subchid)
        lo = s.start_cu * C.CU_BITS
        sub_soft = msc[..., lo: lo + s.size_cus * C.CU_BITS]
        with spans.span("demod.deinterleave"):
            ring, aligned = time_deinterleave(rings[key], cif_count,
                                              sub_soft)
        new_rings[key] = ring
        out["probe_soft"][key] = aligned
    with spans.span("demod.depuncture"):
        jobs = [depuncture(fic_soft, FIC_PROFILE)]
    groups: dict = {}
    if ensemble is not None:
        for s in ensemble.subchannels:
            groups.setdefault(s.profile, []).append(s)
        for profile, subs in groups.items():
            aligned_all = []
            for s in subs:
                key = str(s.subchid)
                lo = s.start_cu * C.CU_BITS
                sub_soft = msc[..., lo: lo + profile.tx_bits]
                with spans.span("demod.deinterleave"):
                    ring, aligned = time_deinterleave(
                        rings[key], cif_count, sub_soft)
                new_rings[key] = ring
                aligned_all.append(aligned)
            # (..., subs * n_cifs, tx_bits), stream-major in the lanes
            with spans.span("demod.depuncture"):
                jobs.append(depuncture(torch.cat(
                    aligned_all, dim=-2).reshape(-1, profile.tx_bits),
                    profile))
    return out, new_rings, jobs, groups


def post_viterbi(out: dict, groups: dict, decoded: list, n_frames: int,
                 mode=C.MODE_I) -> dict:
    """The chain after the Viterbi: descramble and pack the decoded bits
    of :func:`pre_viterbi`'s ``jobs`` (``decoded``, in the same order)
    into ``out``'s FIB bytes and sub-channel rows, unflattening the lanes
    stream-major into ``out``'s leading stream shape.  Returns ``out``."""
    lead = out["prs_offset"].shape[:-1]
    n_cifs = n_frames * mode.n_cifs
    fic_bits, fic_metric = decoded[0]
    out["fib_bytes"] = pack_bits(descramble(fic_bits)).reshape(
        *lead, n_frames, mode.n_fibs, C.FIB_BYTES)
    n_cw = (n_frames * mode.fic_bits_per_frame) // C.FIC_PUNCTURED_BITS
    out["fic_metric"] = fic_metric.reshape(
        *lead, *((n_frames, -1) if n_cw % n_frames == 0 else (-1,)))
    for (profile, subs), (bits, metric) in zip(groups.items(),
                                               decoded[1:]):
        rows = len(subs) * n_cifs
        # (..., subs * n_cifs, data_bytes)
        data = pack_bits(descramble(bits)).reshape(*lead, rows, -1)
        metric = metric.reshape(*lead, rows)
        for k, s in enumerate(subs):
            key = str(s.subchid)
            sl = slice(k * n_cifs, (k + 1) * n_cifs)
            out["subch"][key] = data[..., sl, :]
            out["subch_metric"][key] = metric[..., sl]
    return out


def pipeline_core(x, frame_start_guesses, rings, cif_count, *,
                  ensemble: Ensemble | None, mode=C.MODE_I,
                  search: int = 192, max_int_cfo: int = 8,
                  sync_diag: dict | None = None,
                  probe_subs: tuple = ()):
    """The shared demod+decode chain: :func:`pre_viterbi`, the block's ONE
    ragged Viterbi dispatch, :func:`post_viterbi`.  Arguments as
    :func:`pre_viterbi`'s, one stream or a leading axis of them.
    Returns ``(out, rings', cif_count')``.
    """
    n_frames = frame_start_guesses.shape[-1]
    with spans.span("enqueue.demod"):
        out, new_rings, jobs, groups = pre_viterbi(
            x, frame_start_guesses, rings, cif_count, ensemble=ensemble,
            mode=mode, search=search, max_int_cfo=max_int_cfo,
            sync_diag=sync_diag, probe_subs=probe_subs)
    with spans.span("enqueue.viterbi"):
        decoded = viterbi_decode_ragged(jobs)
    with spans.span("enqueue.pack"):
        post_viterbi(out, groups, decoded, n_frames, mode)
    return out, new_rings, cif_count + n_frames * mode.n_cifs


def process_block(x, rings, cif_count, *, ensemble: Ensemble | None,
                  mode=C.MODE_I, n_frames: int = 8, search: int = 192,
                  max_int_cfo: int = 8, probe_subs: tuple = (),
                  tii: bool = False, graphs: ChainGraphs | None = None):
    """Decode ``n_frames`` transmission frames from sample block ``x``.

    Coarse-syncs on the null symbol, then runs :func:`pipeline_core`.
    Returns ``(out, rings, cif_count')``.  ``ensemble=None`` is the
    FIC-only acquisition pass.  ``tii`` adds the block's TII pair powers
    and noise floor (``ops.tii.tii_powers_at`` at the coarse null
    position) to ``out`` as ``tii_powers`` and ``tii_floor``, so they
    come home in the block's one device->host copy.

    ``x`` may be complex64 samples OR raw uint8 offset-128 interleaved IQ
    (the RTL-SDR wire format, 2 bytes/sample), converted on the device, so
    a u8 source ships 4x fewer bytes to the device.

    ``graphs``: a receiver's ``models.graphs.ChainGraphs``, which on a
    CUDA device captures this chain once per key and replays it for
    later blocks; its outputs are then valid until the next call with
    the same cache.  None launches the chain op by op.

    Span ``rx.enqueue`` (the launches), with ``enqueue.sync`` and
    :func:`pipeline_core`'s stages inside it on a pass that launches op
    by op, and ``enqueue.graph`` on a replay.
    """
    kw = dict(ensemble=ensemble, mode=mode, n_frames=n_frames,
              search=search, max_int_cfo=max_int_cfo,
              probe_subs=probe_subs, tii=tii)
    with spans.span("rx.enqueue"):
        if graphs is None:
            return _chain(x, rings, cif_count, **kw)
        return graphs(_chain, x, rings, cif_count, **kw)


def _chain(x, rings, cif_count, *, ensemble, mode, n_frames, search,
           max_int_cfo, probe_subs, tii):
    """:func:`process_block`'s device chain, launched op by op (what a
    ``ChainGraphs`` capture records)."""
    with spans.span("enqueue.sync"):
        if x.dtype == torch.uint8:
            f = (x.to(torch.float32) - 128.0) / 64.0
            x = torch.complex(f[0::2], f[1::2])
        sync = coarse_null_sync(x, mode)
        ns = sync["null_start"]
        frame_off = torch.arange(n_frames, dtype=torch.int32,
                                 device=x.device) * mode.frame_size
        sync_diag = {"null_start": ns, "null_ratio": sync["null_ratio"]}
        if tii:
            t = tii_powers_at(x, ns, n_frames, mode)
            sync_diag.update(tii_powers=t["powers"],
                             tii_floor=t["floor"])
    return pipeline_core(
        x, ns + frame_off, rings, cif_count, ensemble=ensemble,
        mode=mode, search=search, max_int_cfo=max_int_cfo,
        sync_diag=sync_diag, probe_subs=probe_subs)


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.uint8: np.uint8}


def to_host(tree: dict) -> dict:
    """Copy a (nested) dict of device tensors to NumPy arrays in ONE
    device->host transfer: every leaf is viewed as bytes, concatenated on
    the device, copied once, and split again on the host.  Spans
    ``rx.wait`` and ``rx.d2h`` (see :func:`spans.download`)."""
    leaves = []

    def collect(node):
        for v in node.values():
            if isinstance(v, dict):
                collect(v)
            else:
                leaves.append(v)

    collect(tree)
    if not leaves:
        return {}
    flat = spans.download(
        torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                   for t in leaves]), "rx.wait", "rx.d2h")
    it = iter(leaves)
    pos = 0

    def rebuild(node):
        nonlocal pos
        res = {}
        for k, v in node.items():
            if isinstance(v, dict):
                res[k] = rebuild(v)
                continue
            t = next(it)
            nbytes = t.numel() * t.element_size()
            res[k] = flat[pos: pos + nbytes].view(
                _NP_DTYPES[t.dtype]).reshape(tuple(t.shape))
            pos += nbytes
        return res

    return rebuild(tree)


def pick_stream(tree: dict, j: int) -> dict:
    """Stream ``j`` of a (nested) dict of tensors with a leading stream
    axis, as views."""
    return {k: pick_stream(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


@dataclasses.dataclass
class FrameStats:
    """Per-block observability record."""

    cif_count: int
    null_start: int
    null_ratio: float
    cfo_carriers: float
    prs_peak_min: float
    fib_crc_ok: int
    fib_crc_bad: int
    # RMS delay spread of the PRS channel impulse response (us), mean
    # over the block's frames.
    delay_spread_us: float = 0.0

    @property
    def snr_db(self) -> float:
        """SNR estimated from the null-symbol noise floor (see SNR_CAVEAT
        in ops.sync)."""
        return null_ratio_to_snr_db(self.null_ratio)


def from_jax_state(ckpt: dict, device) -> dict:
    """A checkpoint dict of either package (rings as NumPy arrays or
    tensors) -> the same dict with its rings as float32 tensors on
    ``device`` and the CIF counter as an int."""
    out = dict(ckpt)
    out["cif_count"] = int(ckpt["cif_count"])
    if ckpt.get("rings") is not None:
        out["rings"] = {
            k: (v if torch.is_tensor(v) else torch.from_numpy(
                np.array(v, dtype=np.float32))).to(device, torch.float32)
            for k, v in ckpt["rings"].items()}
    return out


class DabReceiver:
    """Streaming IQ -> ETI receiver with FIC acquisition (host orchestrator).

    Feed complex64 or u8 baseband at 2.048 Msps via :meth:`feed`, as NumPy
    arrays or, from a front end, as complex64 tensors on ``device``;
    collect ETI frames from the returned list.  The first blocks run
    FIC-only until the MCI is parsed; then the pipeline specializes to the
    ensemble and starts emitting ETI once the 16-CIF deinterleaver is
    primed.

    ``device``: where every block runs, end to end.  Required; the
    receiver never picks or changes it.
    """

    def __init__(self, n_frames: int = 8, mode=C.MODE_I,
                 ensemble: Ensemble | None = None, emit_eti: bool = True,
                 stats_jsonl=None, tii: bool = False, tist: bool = False,
                 uep_autoprobe: bool = True, *, device):
        self.device = torch.device(device)
        self.mode = mode
        self.n_frames = n_frames
        # Signal-driven identification of non-bundled UEP Table 33 rows
        # (ops/uep_probe.py).
        self._uep_autoprobe = uep_autoprobe
        self._probe: dict[str, dict] = {}
        self._probe_subs: tuple = ()
        # TIST source: False = no TIST; True = stream-relative phase;
        # "utc" = this host's wall clock at activation; a float = the
        # UTC/GPS seconds timestamp of stream sample 0.
        self._tist_enabled = tist
        # TII accumulation across blocks (EN 300 401 s14.8; ops/tii.py),
        # in float64 on the host, as the JAX receiver accumulates it.
        self._tii_enabled = tii
        self._tii_powers = np.zeros((24, 8), dtype=np.float64)
        self._tii_floor = 0.0
        self.emit_eti = emit_eti
        # Input ring: caller-provided chunks consumed by view slicing,
        # NumPy arrays (uploaded a block at a time) or tensors on the
        # device (kept there).
        self._chunks: list = []
        self._buffered = 0
        # Blocks uploaded from a NumPy ring ("host") and blocks taken
        # from a tensor ring ("card"), replays included.
        self.input_counts = {"host": 0, "card": 0}
        self._fig = FigParser()
        self.ensemble = ensemble
        self._decode: Ensemble | None = None   # ensemble minus undecodables
        self._rings = None
        # The CIF counter lives on the device (it feeds the deinterleaver
        # index arithmetic); _cif_host mirrors it for host bookkeeping, so
        # no block reads it back.
        self._cif_host = 0
        self._cif_count = self._cif_tensor(0)
        self._fib_fifo: dict[int, list[bytes]] = {}
        self._err_level: dict[int, int] = {}
        self._assembler: EtiAssembler | None = None
        self._activation_cif: int | None = None
        self._subch_fifo: dict[int, dict[int, bytes]] = {}
        self.stats: list[FrameStats] = []
        # Device steps run (process_block calls, replays included).
        self.device_steps = 0
        # The device chain as CUDA graphs, one pair per decode key
        # (models/graphs.py); its ``counts`` tally eager passes, captures
        # and graph replays.  None (the CPU) launches op by op.
        self.graphs = (ChainGraphs() if self.device.type == "cuda"
                       else None)
        self._reconfig_candidate = None
        # MCI FIBs repeat identically frame after frame; skip re-parsing
        # duplicates (but still tick the parser's staleness clock).
        self._fib_cache: dict[bytes, tuple] = {}
        self._stats_jsonl = (open(stats_jsonl, "a")
                             if isinstance(stats_jsonl, (str, bytes))
                             else stats_jsonl)
        if ensemble is not None:
            self._activate(ensemble)

    def _cif_tensor(self, n: int) -> torch.Tensor:
        return torch.tensor(n, dtype=torch.int32, device=self.device)

    def _set_cif(self, n: int) -> None:
        self._cif_host = int(n)
        self._cif_count = self._cif_tensor(n)

    def _log_stats_jsonl(self, out: dict) -> None:
        if self._stats_jsonl is None:
            return
        import json
        s = self.stats[-1]
        rec = dataclasses.asdict(s)
        rec["snr_db"] = round(s.snr_db, 2)
        rec["snr_method"] = SNR_METHOD
        rec["snr_caveat"] = SNR_CAVEAT
        rec["fic_metric_mean"] = float(np.mean(out["fic_metric"]))
        for key, m in out.get("subch_metric", {}).items():
            # Viterbi path metric as a per-sub-channel BER proxy
            rec[f"subch{key}_metric_mean"] = float(np.mean(m))
        self._stats_jsonl.write(json.dumps(rec) + "\n")
        self._stats_jsonl.flush()

    # ------------------------------------------------------------- feed
    PREROLL = 4096  # samples kept before the next frame's null symbol

    def feed(self, samples) -> list[bytes]:
        """Consume samples; return any completed ETI frames.

        ``samples``: a NumPy array, complex64 or raw uint8 offset-128
        interleaved IQ (converted on the device), each block uploaded; or
        an (n,) complex64 tensor on the receiver's device (a front end's
        output), each block taken there.  Do not mix formats, nor arrays
        and tensors, on one receiver.  Span ``rx.feed``, the root of the
        call's spans.
        """
        with spans.span("rx.feed"):
            if torch.is_tensor(samples):
                s, eps = self._device_chunk(samples), 1
            else:
                s = np.asarray(samples)
                if s.dtype == np.uint8:
                    eps = 2            # buffer elements per sample
                else:
                    s = np.asarray(s, dtype=np.complex64)
                    eps = 1
            if self._chunks and (torch.is_tensor(self._chunks[0])
                                 != torch.is_tensor(s)):
                raise ValueError("cannot mix NumPy and tensor feeds")
            if self._chunks and self._chunks[0].dtype != s.dtype:
                raise ValueError("cannot mix u8 and complex64 feeds")
            if _length(s):
                self._chunks.append(s)
                self._buffered += _length(s)
            eti: list[bytes] = []
            need = block_samples(self.n_frames, self.mode) * eps
            while self._buffered >= need:
                eti.extend(self._process_one_block(self._peek(need)))
                # Advance relative to the *measured* null position so
                # sample-clock drift cannot skip/repeat a frame; keep a
                # fixed pre-roll so the next block's coarse argmin lands
                # on the immediately-next null dip.
                ns = self.stats[-1].null_start if self.stats else 0
                advance = max(ns + self.n_frames * self.mode.frame_size
                              - self.PREROLL, 1)
                self._drop(min(advance * eps, self._buffered))
            return eti

    def pending_samples(self) -> np.ndarray:
        """Buffered-but-unprocessed samples, as NumPy whatever was fed
        (e.g. to carry across a checkpoint/restore: feed them to the
        restored receiver first)."""
        if not self._chunks:
            return np.zeros(0, dtype=np.complex64)
        out = self._peek(self._buffered)
        if torch.is_tensor(out):
            return out.to("cpu", copy=True).numpy()
        return out.copy()

    def _device_chunk(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor fed in, once checked: (n,) complex64 on this
        receiver's device."""
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if t.dtype != torch.complex64 or t.dim() != 1 or t.device != dev:
            raise ValueError(f"a tensor feed must be (n,) complex64 on "
                             f"{dev}; got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        return t

    def _peek(self, n: int):
        """First ``n`` buffered samples (zero-copy when one chunk covers
        them; otherwise one block-sized gather, span ``rx.ring``: into a
        fresh host array, or one ``torch.cat`` on the device)."""
        first = self._chunks[0]
        if torch.is_tensor(first):
            if first.shape[0] >= n:
                return first[:n]
            with spans.span("rx.ring"):
                parts, pos = [], 0
                for c in self._chunks:
                    parts.append(c[:n - pos])
                    pos += parts[-1].shape[0]
                    if pos == n:
                        break
                return torch.cat(parts)
        if first.size >= n:
            return first[:n]
        with spans.span("rx.ring"):
            out = np.empty(n, dtype=first.dtype)
            pos = 0
            for c in self._chunks:
                take = min(n - pos, c.size)
                out[pos:pos + take] = c[:take]
                pos += take
                if pos == n:
                    break
            return out

    def _drop(self, n: int) -> None:
        """Discard the first ``n`` buffered samples (view slicing only)."""
        self._buffered -= n
        while n:
            c = self._chunks[0]
            if _length(c) <= n:
                n -= _length(c)
                self._chunks.pop(0)
            else:
                self._chunks[0] = c[n:]
                n = 0

    def tii(self, min_snr: float = 3.0):
        """Best transmitter identification accumulated so far, or None.

        Requires ``tii=True`` at construction; returns
        :class:`dabtools_tpu_torch.ops.tii.TiiDetection`.
        """
        if not self._tii_enabled or self._tii_floor == 0.0:
            return None
        return solve_tii(self._tii_powers, self._tii_floor, min_snr)

    # ------------------------------------------------------- internals
    def _activate(self, ensemble: Ensemble) -> None:
        self.ensemble = ensemble
        # Never die mid-stream on a sub-channel we cannot decode (e.g. a
        # UEP profile row that isn't bundled): drop it from the decode
        # config and the ETI STC, decode the rest of the mux.
        dropped = [s for s in ensemble.subchannels if not s.decodable]
        if dropped:
            log.warning(
                "skipping %d sub-channel(s) with unavailable puncturing "
                "profiles: %s", len(dropped),
                [(s.subchid, f"{s.protection_type}-P{s.protection_level}",
                  f"{s.bitrate_kbps}k") for s in dropped])
        self._decode = Ensemble(
            eid=ensemble.eid, label=ensemble.label, services=ensemble.services,
            subchannels=tuple(s for s in ensemble.subchannels if s.decodable))
        self._rings = {
            str(s.subchid): init_deinterleave_ring(s.profile.tx_bits,
                                                   self.device)
            for s in self._decode.subchannels}
        # Skipped UEP sub-channels become probe targets: their CU slice
        # deinterleaves on the device, and ops/uep_probe identifies the
        # puncturing row from the signal itself.
        self._probe = {}
        probe_subs = []
        if self._uep_autoprobe:
            from dabtools_tpu_torch.tables.puncturing import (
                enumerate_uep_candidates)
            for s in dropped:
                if s.protection_type != "UEP":
                    continue
                try:
                    cands = enumerate_uep_candidates(
                        s.bitrate_kbps, s.protection_level)
                except ValueError:
                    continue
                if cands:
                    probe_subs.append(s)
                    self._probe[str(s.subchid)] = {
                        "sub": s, "cands": cands, "rows": [],
                        "attempts": 0}
                    self._rings[str(s.subchid)] = init_deinterleave_ring(
                        s.size_cus * C.CU_BITS, self.device)
        self._probe_subs = tuple(probe_subs)
        # TIST phase continues across (re)activations: frame N of the ETI
        # output corresponds to received CIF N, 24 ms apart.  Identity
        # checks, not truthiness: epoch 0.0 is a valid anchor.
        if self._tist_enabled is False or self._tist_enabled is None:
            tist_start = None
        elif self._tist_enabled is True:
            tist_start = (self._cif_host * 24e-3) % 1.0
        elif self._tist_enabled == "utc":
            import time
            tist_start = time.time() % 1.0
        else:
            tist_start = (float(self._tist_enabled)
                          + self._cif_host * 24e-3) % 1.0
        self._assembler = EtiAssembler(self._decode, self.mode,
                                       tist_start=tist_start)
        self._activation_cif = self._cif_host
        # Any (re)activation invalidates the FIB parse cache.
        self._fib_cache.clear()
        # First fully-valid logical frame: its 16 interleaved contributions
        # are received CIFs n..n+15, all >= activation.
        self._next_eti_cif = self._activation_cif
        for n in [k for k in self._fib_fifo if k < self._activation_cif]:
            self._fib_fifo.pop(n)
            self._err_level.pop(n, None)
        log.info("ensemble activated: eid=0x%04X subchannels=%s",
                 ensemble.eid,
                 [(s.subchid, s.size_cus) for s in ensemble.subchannels])

    _PROBE_ROWS_PER_ATTEMPT = 4
    _PROBE_MAX_ATTEMPTS = 2

    def _identify_uep_rows(self, out: dict, cif0: int) -> bool:
        """Feed this block's probe rows to ops/uep_probe; True iff a row
        was identified and registered (caller then re-specializes)."""
        from dabtools_tpu_torch.tables.puncturing import register_uep_profile
        from dabtools_tpu_torch.ops.uep_probe import identify_uep_profile
        identified = False
        n_rows_blk = self.n_frames * self.mode.n_cifs
        # Row j (output CIF cif0+j) is fully primed iff its oldest
        # contribution, received CIF cif0+j-15, post-dates activation.
        j0 = max(0, self._activation_cif + 15 - cif0)
        for key, st in list(self._probe.items()):
            aligned = out["probe_soft"][key]
            want = self._PROBE_ROWS_PER_ATTEMPT * (st["attempts"] + 1)
            # Never collect the same output CIF twice (replays re-run a
            # block through this method with state preserved).
            j_start = max(j0, st.get("upto", 0) - cif0)
            for j in range(j_start, n_rows_blk):
                if len(st["rows"]) < want:
                    st["rows"].append(np.array(aligned[j]))
            st["upto"] = cif0 + n_rows_blk
            if len(st["rows"]) < want:
                continue
            st["attempts"] += 1
            idx, diag = identify_uep_profile(
                np.stack(st["rows"]), st["cands"], self.device)
            s = st["sub"]
            if idx is not None:
                p = st["cands"][idx]
                register_uep_profile(s.bitrate_kbps, s.protection_level,
                                     p.regions, p.padding_bits)
                log.info(
                    "UEP (%d kbit/s, P%d) puncturing row identified from "
                    "signal for subch %s: regions=%s pad=%d (metric %.3f, "
                    "gap %.4f over %d rows); re-specializing",
                    s.bitrate_kbps, s.protection_level, key, p.regions,
                    p.padding_bits, diag["best_metric"], diag["gap"],
                    diag["n_rows"])
                del self._probe[key]
                identified = True
            elif st["attempts"] >= self._PROBE_MAX_ATTEMPTS:
                log.warning(
                    "UEP autoprobe inconclusive for subch %s after %d "
                    "rows (best %s, gap %s, per_row_win=%s); leaving "
                    "the sub-channel skipped", key, len(st["rows"]),
                    diag.get("best_metric"), diag.get("gap"),
                    diag.get("per_row_win", diag.get("reason")))
                del self._probe[key]
        if not self._probe:
            # All probes resolved or abandoned: drop the probe slices from
            # the device step.
            self._probe_subs = ()
        return identified

    def _upload(self, x) -> torch.Tensor:
        """The block on the device: a tensor as it is, an array uploaded
        (span ``rx.h2d``).  Counted in ``input_counts``."""
        if torch.is_tensor(x):
            self.input_counts["card"] += 1
            return x
        self.input_counts["host"] += 1
        if not x.flags.writeable:
            with spans.span("rx.ring"):
                x = x.copy()
        with spans.span("rx.h2d", x.nbytes):
            return torch.from_numpy(x).to(self.device)

    def _process_one_block(self, x,
                           _replay: str | None = None) -> list[bytes]:
        """``_replay``: this is the second pass over the SAME block, and
        its cause (``"acquire"``, ``"reconfig"`` or ``"autoprobe"``
        re-specialization).  Stats/JSONL records and FIG feeding are
        skipped on replays; the ETI-side state is still rebuilt because
        _activate resets it.  Span ``rx.block``, or ``rx.block.<cause>``
        for a replay (inside the pass that replays)."""
        with spans.span(f"rx.block.{_replay}" if _replay else "rx.block"):
            return self._block(x, _replay)

    def _block(self, x, _replay: str | None) -> list[bytes]:
        cif0 = self._cif_host
        # Pre-block deinterleaver state, kept for the autoprobe replay.
        pre_rings = dict(self._rings) if self._rings else {}
        ens = (self._decode.decode_config()
               if self.ensemble is not None else None)
        # the upload is a temporary, freed when process_block returns: the
        # caching allocator then hands its memory to the next upload (a
        # replay's included), and the device's memory layout, which the
        # kernels' times depend on, stays as it is without spans; a graph
        # replay copies it into its static input.  A tensor fed in passes
        # through: no operation of the chain writes into its input, so a
        # replay reads the same samples again
        out_dev, rings, cif_next = process_block(
            self._upload(x), self._rings or {}, self._cif_count,
            ensemble=ens, mode=self.mode, n_frames=self.n_frames,
            probe_subs=self._probe_subs, tii=self._tii_enabled,
            graphs=self.graphs)
        self.device_steps += 1
        out = to_host(out_dev)                 # the block's one D2H copy
        self._cif_count = cif_next
        self._cif_host = cif0 + self.n_frames * self.mode.n_cifs
        if self.ensemble is not None:
            self._rings = rings
        # Every pass accumulates, replays included, as in the JAX receiver.
        if self._tii_enabled:
            self._tii_powers += np.asarray(out["tii_powers"],
                                           dtype=np.float64)
            self._tii_floor += float(out["tii_floor"])

        # FIBs arrive packed from the device: (B, 12, 32) uint8.  All CRCs
        # for the block are checked in ONE native call.
        with spans.span("rx.fic"):
            fib_bytes = out["fib_bytes"]
            fib_ok = crc16_ok_batch(
                fib_bytes.reshape(-1, C.FIB_BYTES)).reshape(
                self.n_frames, self.mode.n_fibs)
            n_ok = int(fib_ok.sum())
            n_bad = fib_ok.size - n_ok
            fibs_per_cif = self.mode.n_fibs // self.mode.n_cifs
            # Per-frame sync confidence drives the ETI ERR byte: bad PRS
            # correlation or a vanished null dip degrade the frame; FIB CRC
            # failures degrade the specific CIF.
            null_ratio = float(out["null_ratio"])
            prs_peak = out["prs_peak"]
            for f in range(self.n_frames):
                frame_sync_bad = (prs_peak[f] < 0.2) or (null_ratio > 0.5)
                for i in range(self.mode.n_fibs):
                    if fib_ok[f, i] and not _replay:
                        fib = fib_bytes[f, i].tobytes()
                        if fib in self._fib_cache:
                            self._fig.tick(self._fib_cache[fib])
                        else:
                            n_figs = self._fig.feed_fib(fib)
                            self._fib_cache[fib] = n_figs
                            if len(self._fib_cache) > 4096:
                                self._fib_cache.clear()
                for c in range(self.mode.n_cifs):
                    n = cif0 + f * self.mode.n_cifs + c
                    triplet = [fib_bytes[f, fibs_per_cif * c + k].tobytes()
                               for k in range(fibs_per_cif)]
                    crc_bad = int(
                        (~fib_ok[f, fibs_per_cif * c: fibs_per_cif * (c + 1)])
                        .sum())
                    level = 0
                    if frame_sync_bad:
                        level = 2
                    elif crc_bad:
                        level = 1
                    self._fib_fifo[n] = triplet
                    self._err_level[n] = level

        if not _replay:
            self.stats.append(FrameStats(
                cif_count=cif0,
                null_start=int(out["null_start"]),
                null_ratio=null_ratio,
                cfo_carriers=float(out["cfo_carriers"]),
                prs_peak_min=float(np.min(prs_peak)),
                fib_crc_ok=n_ok, fib_crc_bad=n_bad,
                delay_spread_us=float(np.mean(out["delay_spread"]))
                * 1e6 / C.SAMPLE_RATE))
            self._log_stats_jsonl(out)

        # Acquisition -> activation: rewind and reprocess the same block
        # with the MSC decode enabled so its CIFs aren't lost.
        if self.ensemble is None and self._fig.have_mci():
            self._set_cif(cif0)
            self._activate(self._fig.ensemble())
            return self._process_one_block(x, _replay="acquire")

        # Ensemble reconfiguration (multiplex changes signalled via FIG).
        # Metadata-only changes update in place; a changed SUB-CHANNEL ORG
        # re-specializes the pipeline, but only after being seen in two
        # consecutive blocks.
        if self.ensemble is not None and self._fig.have_mci():
            new_ens = self._fig.ensemble()
            if new_ens.subchannels == self.ensemble.subchannels:
                self._reconfig_candidate = None
                if new_ens != self.ensemble:
                    self.ensemble = new_ens
                    self._assembler.ensemble = new_ens
            elif self._reconfig_candidate == new_ens.subchannels:
                log.info("ensemble reconfiguration confirmed "
                         "(0x%04X): re-specializing", new_ens.eid)
                self._reconfig_candidate = None
                pending = self._emit_eti() if self.emit_eti else []
                self._set_cif(cif0)
                self._subch_fifo.clear()
                self._activate(new_ens)
                return pending + self._process_one_block(
                    x, _replay="reconfig")
            else:
                self._reconfig_candidate = new_ens.subchannels

        # UEP row autoprobe: once a row is identified, register it and
        # re-run the block with full continuity (pre-block rings for the
        # decodable sub-channels, the probe ring for the new one, ETI
        # fifos, CIF numbering and FCT/TIST counters all continue).
        if self._probe and self._identify_uep_rows(out, cif0):
            keep = (self._activation_cif, dict(self._fib_fifo),
                    dict(self._err_level), self._next_eti_cif,
                    self._assembler.frame_count if self._assembler
                    else 0,
                    self._assembler._tist0 if self._assembler else None)
            prev_probe = dict(self._probe)
            self._set_cif(cif0)
            self._activate(self.ensemble)
            (self._activation_cif, self._fib_fifo, self._err_level,
             self._next_eti_cif, fc, tist0) = keep
            self._probe = {k: st for k, st in self._probe.items()
                           if k in prev_probe}
            for k, st in self._probe.items():
                for f in ("rows", "attempts", "upto"):
                    if f in prev_probe[k]:
                        st[f] = prev_probe[k][f]
            self._probe_subs = tuple(
                s for s in self._probe_subs
                if str(s.subchid) in self._probe)
            if self._assembler is not None:
                self._assembler.frame_count = fc
                self._assembler._tist0 = tist0
            for k, v in pre_rings.items():
                if k in self._rings:
                    self._rings[k] = v
            return self._process_one_block(x, _replay="autoprobe")

        # Sub-channel rows j correspond to logical frames cif0 + j - 15.
        with spans.span("rx.eti"):
            if self.ensemble is not None:
                for s in self._decode.subchannels:
                    data = out["subch"][str(s.subchid)]
                    for j in range(data.shape[0]):
                        n = cif0 + j - 15
                        if n >= 0:
                            self._subch_fifo.setdefault(
                                s.subchid, {})[n] = data[j].tobytes()
            eti = self._emit_eti() if self.emit_eti else []
            self._prune(cif0)
        return eti

    # Bound host-side state so long undecodable or non-emitting runs don't
    # grow without limit.
    MAX_PENDING_CIFS = 256
    MAX_STATS = 4096

    def _prune(self, cif0: int) -> None:
        horizon = cif0 - self.MAX_PENDING_CIFS
        for fifo in (self._fib_fifo, self._err_level, *(
                self._subch_fifo.values())):
            for n in [k for k in fifo if k < horizon]:
                del fifo[n]
        if len(self.stats) > self.MAX_STATS:
            del self.stats[: len(self.stats) - self.MAX_STATS]
        if self.emit_eti and self.ensemble is not None:
            # emission can never progress past dropped entries; skip ahead
            if self._next_eti_cif < horizon:
                log.warning("ETI emission fell behind; skipping CIFs "
                            "%d..%d", self._next_eti_cif, horizon - 1)
                self._next_eti_cif = horizon

    def _emit_eti(self) -> list[bytes]:
        if self.ensemble is None or self._assembler is None:
            return []
        fibs_list, subch_list, err_list = [], [], []
        while True:
            n = self._next_eti_cif
            have = (n in self._fib_fifo and all(
                n in self._subch_fifo.get(s.subchid, {})
                for s in self._decode.subchannels))
            if not have:
                break
            subch_list.append(
                {s.subchid: self._subch_fifo[s.subchid].pop(n)
                 for s in self._decode.subchannels})
            fibs_list.append(self._fib_fifo.pop(n))
            err_list.append(self._err_level.pop(n, 0))
            self._next_eti_cif = n + 1
        # One native crossing per device block, not per 24 ms frame.
        return self._assembler.frame_batch(fibs_list, subch_list, err_list)

    # --------------------------------------------------- checkpointing
    def checkpoint(self) -> dict:
        """Serializable cross-block state, in the JAX package's format
        (rings as NumPy arrays)."""
        return {
            "cif_count": self._cif_host,
            "rings": None if self._rings is None else
                     {k: v.cpu().numpy() for k, v in self._rings.items()},
            "ensemble": self.ensemble,
            "activation_cif": self._activation_cif,
            "next_eti_cif": getattr(self, "_next_eti_cif", None),
            "fib_fifo": dict(self._fib_fifo),
            "err_level": dict(self._err_level),
            "subch_fifo": {k: dict(v) for k, v in self._subch_fifo.items()},
            # ETI FCT/FP continuity across resume.
            "frame_count": (self._assembler.frame_count
                            if self._assembler is not None else 0),
            # UEP rows beyond the bundled table (user-registered or
            # autoprobe-identified) live in process-global state; a resume
            # in a fresh process must not lose them.
            "uep_rows": self._extra_uep_rows(),
        }

    @staticmethod
    def _extra_uep_rows() -> dict:
        from dabtools_tpu_torch.tables.puncturing import (_UEP_TABLE_33,
                                                    UEP_PROFILES)
        return {f"{kb}:{lv}": {"regions": [list(r) for r in p.regions],
                               "padding_bits": p.padding_bits}
                for (kb, lv), p in UEP_PROFILES.items()
                if (kb, lv) not in _UEP_TABLE_33}

    def save_checkpoint(self, path: str) -> None:
        """Serialize the resumable state to ``path`` as a PICKLE-FREE
        ``.npz`` container (the JAX package's format): deinterleaver rings
        as arrays, everything else as a JSON document with byte payloads
        hex-encoded."""
        import json

        ckpt = self.checkpoint()
        arrays = {}
        if ckpt["rings"] is not None:
            arrays = {f"ring_{k}": v for k, v in ckpt["rings"].items()}
        meta = {
            "cif_count": ckpt["cif_count"],
            "ensemble": (None if ckpt["ensemble"] is None
                         else ckpt["ensemble"].to_dict()),
            "activation_cif": ckpt["activation_cif"],
            "next_eti_cif": ckpt["next_eti_cif"],
            "frame_count": ckpt["frame_count"],
            "fib_fifo": {str(n): [b.hex() for b in v]
                         for n, v in ckpt["fib_fifo"].items()},
            "err_level": {str(n): v for n, v in ckpt["err_level"].items()},
            "subch_fifo": {str(sc): {str(n): b.hex()
                                     for n, b in fifo.items()}
                           for sc, fifo in ckpt["subch_fifo"].items()},
            "uep_rows": ckpt["uep_rows"],
        }
        with open(path, "wb") as fh:    # exact path (np would append .npz)
            np.savez_compressed(
                fh, __meta__=np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8), **arrays)

    @classmethod
    def load_checkpoint(cls, path: str, **kwargs) -> "DabReceiver":
        import json

        z = np.load(path)               # pickle disabled by default
        meta = json.loads(bytes(z["__meta__"]).decode())
        ckpt = {
            "cif_count": meta["cif_count"],
            "ensemble": (None if meta["ensemble"] is None
                         else Ensemble.from_dict(meta["ensemble"])),
            "activation_cif": meta["activation_cif"],
            "next_eti_cif": meta["next_eti_cif"],
            "frame_count": meta["frame_count"],
            "rings": {k[len("ring_"):]: z[k] for k in z.files
                      if k.startswith("ring_")} or None,
            "fib_fifo": {int(n): [bytes.fromhex(h) for h in v]
                         for n, v in meta["fib_fifo"].items()},
            "err_level": {int(n): v
                          for n, v in meta["err_level"].items()},
            "subch_fifo": {int(sc): {int(n): bytes.fromhex(h)
                                     for n, h in fifo.items()}
                           for sc, fifo in meta["subch_fifo"].items()},
            "uep_rows": meta.get("uep_rows", {}),
        }
        rx = cls(**kwargs)
        rx.restore(ckpt)
        return rx

    def restore(self, ckpt: dict) -> None:
        """Resume from a checkpoint dict of either package (see
        :func:`from_jax_state`)."""
        # Re-register extra UEP rows BEFORE activation so the sub-channel
        # is decodable immediately.  A row already present in this
        # process wins over the checkpoint's.
        from dabtools_tpu_torch.tables.puncturing import (UEP_PROFILES,
                                                    register_uep_profile)
        ckpt = from_jax_state(ckpt, self.device)
        for key, d in ckpt.get("uep_rows", {}).items():
            kb, lv = (int(v) for v in key.split(":"))
            if (kb, lv) not in UEP_PROFILES:
                register_uep_profile(
                    kb, lv, tuple(tuple(r) for r in d["regions"]),
                    d["padding_bits"])
        self._set_cif(ckpt["cif_count"])
        if ckpt["ensemble"] is not None:
            self._activate(ckpt["ensemble"])
            self._rings = dict(ckpt["rings"])
            self._activation_cif = ckpt["activation_cif"]
            if ckpt["next_eti_cif"] is not None:
                self._next_eti_cif = ckpt["next_eti_cif"]
            if self._assembler is not None:
                self._assembler.frame_count = ckpt.get("frame_count", 0)
        self._fib_fifo = dict(ckpt.get("fib_fifo", {}))
        self._err_level = dict(ckpt.get("err_level", {}))
        self._subch_fifo = {k: dict(v)
                            for k, v in ckpt.get("subch_fifo", {}).items()}
