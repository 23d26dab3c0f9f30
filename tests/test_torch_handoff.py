"""The front ends hand their output to the receivers on the device.

``Channelizer`` and ``Resampler`` return tensors on their device, and
``DabReceiver.feed`` takes a complex64 tensor on its own device and keeps
it there: a block that spans two chunks is one ``torch.cat`` on the
device, and no block is uploaded.  A NumPy feed takes the path it always
took.  On the CPU (tier 1) the tensor path runs on CPU tensors: the
wideband loop (both channelizer methods) and the 2.4 Msps resampler loop
emit the same ETI bytes whether the rows are fed as tensors or as NumPy
copies, across chunks that straddle blocks and the acquisition replay;
``input_counts``, ``pending_samples``, and the refusals.  On the card
(marker ``gpu``; it skips without CUDA) one ``wideband3`` hand-over runs
with no download from the front end and no upload into a receiver, the
receivers' graphs replaying.  The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_handoff.py -m gpu
"""

import functools

import numpy as np
import pytest
import torch

from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.models import receiver as R
from dabtools_tpu_torch.ops.fir import Channelizer
from dabtools_tpu_torch.ops.resample import Resampler
from dabtools_tpu_torch.tables.bandiii import BAND_III
from dabtools_tpu_torch.utils import spans

torch.set_num_threads(2)

N_FRAMES = 4
SEED = 2**31 + 2025
WB_RATE = 8_192_000
WB_CENTER = 178_352_000                 # 5C; 5B and 5D at -/+1.712 MHz
# input chunks: a block (987,136 samples at 2.048 Msps) spans several of
# the short ones, and one long one covers a block alone
WB_CHUNKS = (1_000_003, 777_777, 5_000_000, 1_234_567)
RS_CHUNKS = (300_001, 2_000_000, 123_457, 700_000)


@functools.cache
def _air(frames: int = 14) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    x, _ = S.modulate(S.closed_loop_ensemble(), frames, rng)
    return x


@functools.cache
def _wideband() -> np.ndarray:
    rng = np.random.default_rng(SEED + 1)
    ens = S.closed_loop_ensemble()
    wide, _ = S.wideband_capture({"5B": ens, "5D": ens}, WB_CENTER, WB_RATE,
                                 14, rng)
    return wide


def _chunks(x: np.ndarray, sizes: tuple):
    pos, k = 0, 0
    while pos < x.size:
        yield x[pos: pos + sizes[k % len(sizes)]]
        pos += sizes[k % len(sizes)]
        k += 1


def _loop(front, x: np.ndarray, sizes: tuple, n_rx: int):
    """``x`` through ``front`` chunk by chunk, each output row into two
    receivers: one fed the tensor, one a NumPy copy.  Returns (tensor-fed
    receivers, their ETI, NumPy-fed receivers, their ETI)."""
    card = [R.DabReceiver(n_frames=N_FRAMES, device="cpu")
            for _ in range(n_rx)]
    host = [R.DabReceiver(n_frames=N_FRAMES, device="cpu")
            for _ in range(n_rx)]
    eti_card, eti_host = [[] for _ in card], [[] for _ in host]
    for chunk in _chunks(x, sizes):
        y = front(chunk)
        assert torch.is_tensor(y) and y.dtype == torch.complex64
        rows = [y] if y.dim() == 1 else list(y)
        kept = [r.clone() for r in rows]
        for i, row in enumerate(rows):
            eti_card[i] += card[i].feed(row)
            eti_host[i] += host[i].feed(row.numpy().copy())
        # no operation of the receiver writes into what it was fed
        assert all(torch.equal(r, k) for r, k in zip(rows, kept))
    return card, eti_card, host, eti_host


def _check_loop(card, eti_card, host, eti_host):
    for rc, ec, rh, eh in zip(card, eti_card, host, eti_host):
        assert rc.ensemble is not None and rh.ensemble is not None
        assert ec == eh and len(ec) > 0
        # one block advanced per stats record, plus the acquisition
        # replay, which re-passes the same block
        assert rc.device_steps == len(rc.stats) + 1 == rh.device_steps
        assert rc.input_counts == {"host": 0, "card": rc.device_steps}
        assert rh.input_counts == {"host": rh.device_steps, "card": 0}
        pc, ph = rc.pending_samples(), rh.pending_samples()
        assert isinstance(pc, np.ndarray) and pc.dtype == np.complex64
        assert pc.size and np.array_equal(pc, ph)


@pytest.mark.parametrize("method", ["fft", "direct"])
def test_wideband_loop_tensor_rows_equal_numpy_rows(method):
    offs = [int(BAND_III[b] - WB_CENTER) for b in ("5B", "5D")]
    ch = Channelizer(WB_RATE, offs, method=method, device="cpu")
    _check_loop(*_loop(ch, _wideband(), WB_CHUNKS, len(offs)))


def test_resampler_loop_tensor_equal_numpy():
    x24 = S.fft_resample(_air(), int(round(_air().size * 75 / 64)))
    rs = Resampler(2_400_000, device="cpu")
    _check_loop(*_loop(rs, x24, RS_CHUNKS, 1))


def test_ring_gathers_a_block_across_tensor_chunks_in_one_cat():
    """A block over three tensor chunks is one ``torch.cat`` inside
    ``rx.ring``, with no ``rx.h2d``; the same feed as NumPy uploads."""
    x = _air()
    n = R.block_samples(N_FRAMES)
    parts = (x[: n // 3], x[n // 3: 2 * n // 3], x[2 * n // 3: n + 10])
    cats = []
    real = torch.cat

    def counted(*a, **k):
        cats.append(len(a[0]))
        return real(*a, **k)

    names = {}
    for kind in ("card", "host"):
        rx = R.DabReceiver(n_frames=N_FRAMES, device="cpu")
        for p in parts[:2]:
            assert rx.feed(torch.from_numpy(p) if kind == "card" else p) == []
        torch.cat = counted
        try:
            spans.enable()
            rx.feed(torch.from_numpy(parts[2]) if kind == "card"
                    else parts[2])
        finally:
            spans.disable()
            torch.cat = real
        names[kind] = [s[0] for s in spans.drain()]
        assert rx.device_steps and rx.input_counts == {
            "host": 0, "card": 0, kind: rx.device_steps}
        if kind == "card":
            # the ring's cat of the three chunks comes first
            assert cats[0] == 3
    assert names["card"][:3] == ["rx.feed", "rx.ring", "rx.block"]
    assert "rx.h2d" not in names["card"]
    assert names["host"][:3] == ["rx.feed", "rx.ring", "rx.block"]
    assert "rx.h2d" in names["host"]


@pytest.mark.parametrize("first,second", [("numpy", "tensor"),
                                          ("tensor", "numpy")])
def test_mixing_numpy_and_tensor_feeds_raises(first, second):
    x = _air()[:50_000]
    feeds = {"numpy": x, "tensor": torch.from_numpy(x.copy())}
    rx = R.DabReceiver(n_frames=N_FRAMES, device="cpu")
    assert rx.feed(feeds[first]) == []
    with pytest.raises(ValueError, match="cannot mix NumPy and tensor"):
        rx.feed(feeds[second])
    assert rx._buffered == 50_000


@pytest.mark.parametrize("bad", [
    torch.zeros(100, dtype=torch.complex128),
    torch.zeros(100, dtype=torch.float32),
    torch.zeros(200, dtype=torch.uint8),
    torch.zeros((2, 100), dtype=torch.complex64),
    torch.zeros(100, dtype=torch.complex64, device="meta"),
], ids=["complex128", "float32", "uint8", "2d", "other_device"])
def test_tensor_of_another_dtype_shape_or_device_raises(bad):
    rx = R.DabReceiver(n_frames=N_FRAMES, device="cpu")
    with pytest.raises(ValueError, match="complex64 on cpu"):
        rx.feed(bad)
    assert rx._buffered == 0 and rx.input_counts == {"host": 0, "card": 0}


def test_empty_tensor_returns_nothing_and_buffers_nothing():
    rx = R.DabReceiver(n_frames=N_FRAMES, device="cpu")
    empty = Resampler(2_400_000, device="cpu")(np.zeros(0, np.complex64))
    assert torch.is_tensor(empty) and empty.numel() == 0
    assert rx.feed(empty) == []
    assert rx.feed(torch.zeros(0, dtype=torch.complex64)) == []
    assert rx._buffered == 0 and rx.pending_samples().size == 0
    # nothing buffered, so a NumPy feed may follow
    assert rx.feed(_air()[:1000]) == []


def test_empty_channelizer_output_is_an_empty_tensor():
    ch = Channelizer(WB_RATE, [0, 1_712_000], device="cpu")
    y = ch(np.zeros(100, np.complex64))
    assert torch.is_tensor(y) and tuple(y.shape) == (2, 0)
    assert y.dtype == torch.complex64


# ------------------------------------------------------------- card
@pytest.mark.gpu
def test_wideband3_handover_stays_on_the_card():
    """``wideband3``'s configuration and traffic through the benchmark's
    front end: receivers fed the channelizer's rows on the card against
    receivers fed NumPy copies of them.  After acquisition and warm-up,
    one traced hand-over downloads nothing from the front end and
    uploads nothing into a receiver, every acquired receiver replays its
    graph, and the ETI bytes equal the NumPy-fed receivers'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dabtools_tpu_torch.mod.impairments import u8_to_complex
    from rxbench import drive
    from rxbench.gen.pool import synthesize
    from rxbench.spec import Spec

    spec = Spec()
    config, traffic = spec.config("wideband3"), spec.traffic("dab2eti")
    drive.build("cuda")
    pool = synthesize(config, traffic, SEED)
    path = drive.Path(config, traffic, "cuda")
    host = [R.DabReceiver(n_frames=int(traffic["frames_per_block"]),
                          device="cuda") for _ in path.receivers]

    def hand(k):
        y = path.front(u8_to_complex(pool.chunk(k)))
        assert y.is_cuda
        card = [rx.feed(y[i]) for i, rx in enumerate(path.receivers)]
        return card, [rx.feed(y[i].cpu().numpy())
                      for i, rx in enumerate(host)]

    n = traffic["acquire_blocks"] + traffic["warmup_blocks"]
    for k in range(n):
        card, want = hand(k)
        assert card == want
    acquired = [rx for rx in path.receivers if rx.ensemble is not None]
    assert len(acquired) == 3
    replays = [rx.graphs.counts["replays"] for rx in acquired]
    spans.enable()
    try:
        y = path.front(u8_to_complex(pool.chunk(n)))
        card = [rx.feed(y[i]) for i, rx in enumerate(path.receivers)]
    finally:
        spans.disable()
    names = {s[0] for s in spans.drain()}
    want = [rx.feed(y[i].cpu().numpy()) for i, rx in enumerate(host)]
    assert "frontend.d2h" not in names and "rx.h2d" not in names
    assert {"frontend", "frontend.h2d", "rx.feed", "rx.block"} <= names
    assert all(rx.graphs.counts["replays"] > r
               for rx, r in zip(acquired, replays))
    assert card == want and any(card)
    for rx in path.receivers:
        assert rx.input_counts == {"host": 0, "card": rx.device_steps}
