"""The receiver's device chain as CUDA graphs (``models/graphs.py``).

On the CPU (tier 1): ``process_block`` with a cache runs op by op and
equals the call without one, and the cache's key tells apart every
keyword that shapes the chain while two ``decode_config()`` calls on the
same sub-channels share one key.

On the card (marker ``gpu``; they skip without CUDA): receivers that
replay their chain against receivers that launch it op by op, on the
flagship and the 17-sub-channel multiplex: the same ETI bytes, final
rings and CIF counter, the same hand-written kernels run on the device
(counted in a device trace), one capture and a replay for every later
block; a reconfiguration that recaptures and
drops the old graphs; rings that are not the cache's static set (a
restore, the ``stale`` fault) giving the bytes of the op-by-op chain;
and the ``flip`` fault still reaching the ETI of replayed blocks.  The
file imports no JAX:

    python -m pytest --noconftest tests/test_torch_graphs.py -m gpu
"""

import collections
import gc
import re
import weakref

import numpy as np
import pytest
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.fic.config import Ensemble, Subchannel
from dabtools_tpu_torch.models import graphs as G
from dabtools_tpu_torch.models import receiver as R
from dabtools_tpu_torch.models.graphs import ChainGraphs, chain_key
from dabtools_tpu_torch.ops import cudalib
from dabtools_tpu_torch.ops.fec import init_deinterleave_ring
from rxbench import faults

torch.set_num_threads(2)

SEED = 2**31 + 2022
N_FRAMES = 4                # blocks of 4 frames on the CPU and across
                            # the reconfiguration
BLOCK = 8                   # dab2eti's blocks on the flagship streams
STREAM_FRAMES = 120         # 14 such blocks of a stream
HAND_WRITTEN = ("acs4", "traceback4", "traceback4_onehot64", "acs2",
                "traceback2")


def _rings(ens: Ensemble, device) -> dict:
    return {str(s.subchid): init_deinterleave_ring(s.profile.tx_bits, device)
            for s in ens.subchannels}


def _block(dtype: str):
    """One 4-frame block of the closed-loop ensemble, complex64 or u8."""
    rng = np.random.default_rng(SEED)
    ens = S.closed_loop_ensemble()
    x, _ = S.modulate(ens, N_FRAMES + 2, rng)
    n = R.block_samples(N_FRAMES)
    if dtype == "uint8":
        return S.impaired_u8(x, rng, 20.0, 300.0, 0)[: 2 * n], ens
    return x[:n], ens


# ------------------------------------------------------------- CPU
@pytest.mark.parametrize("dtype", ["complex64", "uint8"])
def test_cpu_cache_runs_eager_and_equal(dtype):
    """On the CPU a cache never captures: two blocks under one key run
    op by op, and give what the call without a cache gives."""
    xs, ens = _block(dtype)
    dec = ens.decode_config()
    x = torch.from_numpy(xs.copy())
    cif = torch.tensor(16, dtype=torch.int32)
    ref, ref_rings, ref_cif = R.process_block(
        x, _rings(dec, "cpu"), cif, ensemble=dec, n_frames=N_FRAMES)
    cache = ChainGraphs()
    for _ in range(2):
        out, rings, cif_next = R.process_block(
            x, _rings(dec, "cpu"), cif, ensemble=dec, n_frames=N_FRAMES,
            graphs=cache)
        got, want = R.to_host(out), R.to_host(ref)
        assert got.keys() == want.keys()
        for k in ("fib_bytes", "null_start", "prs_offset", "fic_metric"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["subch"]["1"], want["subch"]["1"])
        assert rings.keys() == ref_rings.keys()
        assert all(torch.equal(rings[k], ref_rings[k]) for k in rings)
        assert int(cif_next) == int(ref_cif) == 16 + 4 * N_FRAMES
    assert dict(cache.counts) == {"eager": 2}
    assert cache.key is None


def _key_kw(**change):
    ens = S.flagship_ensemble().decode_config()
    kw = dict(ensemble=ens, mode=C.MODE_I, n_frames=8, search=192,
              max_int_cfo=8, probe_subs=(), tii=False)
    kw.update(change)
    return kw


_X = torch.zeros(2 * R.block_samples(8), dtype=torch.uint8)
_PROBE = Subchannel.uep(5, start_cu=0, table_index=16)
KEY_CHANGES = {
    "configuration": (_X, _key_kw(
        ensemble=S.dabplus17_ensemble().decode_config())),
    "fic_only": (_X, _key_kw(ensemble=None)),
    "mode": (_X, _key_kw(mode=C.MODE_II)),
    "n_frames": (_X, _key_kw(n_frames=4)),
    "search": (_X, _key_kw(search=448)),
    "max_int_cfo": (_X, _key_kw(max_int_cfo=4)),
    "tii": (_X, _key_kw(tii=True)),
    "probe_subs": (_X, _key_kw(probe_subs=(_PROBE,))),
    "dtype": (torch.zeros(R.block_samples(8), dtype=torch.complex64),
              _key_kw()),
    "shape": (_X[:-2], _key_kw()),
}


@pytest.mark.parametrize("field", sorted(KEY_CHANGES))
def test_key_tells_apart_each_field(field):
    """A change to any keyword that shapes the chain, or to the input's
    dtype or shape, is a new key."""
    x, kw = KEY_CHANGES[field]
    assert chain_key(x, **kw) != chain_key(_X, **_key_kw())
    assert chain_key(x, **kw) == chain_key(x.clone(), **dict(kw))


def test_decode_config_calls_share_a_key():
    """Two ``decode_config()`` calls, and two ensembles that differ only
    in what the decode does not use (labels, services, EId), give one
    key; so do inputs of equal shape and different values."""
    ens = S.flagship_ensemble()
    other = S.flagship_ensemble(eid=0x1234, label="OTHER")
    assert other != ens
    keys = {chain_key(x, **_key_kw(ensemble=e.decode_config()))
            for x in (_X, torch.full_like(_X, 7))
            for e in (ens, ens, other)}
    assert len(keys) == 1


# ------------------------------------------------------------ card
@pytest.fixture(scope="module")
def streams():
    """u8 streams of the flagship and the 17-sub-channel multiplex."""
    out = {}
    for name, ens in (("flagship", S.flagship_ensemble()),
                      ("dabplus17", S.dabplus17_ensemble())):
        rng = np.random.default_rng(SEED + len(name))
        x, _ = S.modulate(ens, STREAM_FRAMES, rng)
        out[name] = S.impaired_u8(x, rng, 20.0, 300.0, 3000)
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def keys(monkeypatch):
    """The key of every call on a cache, in order."""
    seen = []

    def recording(x, **chain_kw):
        seen.append(chain_key(x, **chain_kw))
        return seen[-1]

    monkeypatch.setattr(G, "chain_key", recording)
    return seen


def _policy(keys: list) -> dict:
    """The passes that the cache's policy gives for a run of calls with
    ``keys``: per stretch of one key, the first op by op, the second a
    capture, the rest replays."""
    out = collections.Counter()
    for i, k in enumerate(keys):
        n = 1
        while i - n >= 0 and keys[i - n] == k:
            n += 1
        out[("eager", "captures")[n - 1] if n <= 2 else "replays"] += 1
    return dict(out)


def _decode(x, graphs: bool):
    """``x`` through a card receiver of ``BLOCK``-frame blocks with (or
    without) its graph cache, under a device trace: (receiver, ETI
    frames, kernel launches from Python, the hand-written kernels' runs
    on the device by name, a graph's replays included)."""
    from torch.profiler import ProfilerActivity, profile
    rx = R.DabReceiver(n_frames=BLOCK, device="cuda")
    if not graphs:
        rx.graphs = None
    before = cudalib.launches.copy()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eti = rx.feed(x)
        torch.cuda.synchronize()
    ran = collections.Counter()
    for e in prof.key_averages():
        m = re.search(r"(\w+)_kernel\(", e.key)
        if e.device_type.name == "CUDA" and m and m[1] in HAND_WRITTEN:
            ran[m[1]] += e.count
    return rx, eti, cudalib.launches - before, ran


def _same_state(a, b) -> None:
    assert a._cif_host == b._cif_host
    assert int(a._cif_count) == int(b._cif_count) == a._cif_host
    assert a._rings.keys() == b._rings.keys()
    for k in a._rings:
        assert torch.equal(a._rings[k], b._rings[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flagship", "dabplus17"])
def test_replays_match_eager(cuda, streams, keys, name):
    """12 blocks and more: ETI bytes, final rings and CIF counter equal
    the op-by-op receiver's, and so do the hand-written kernels that the
    device trace shows, K1 and K2 once per block.  From Python, K1 and K2
    launch once per block run op by op and twice per capture (its two
    recordings), and not on a replay.  The counter follows the policy:
    under the ensemble's key one block op by op, one capture, and a
    replay for every later block (9 and more), as under the FIC-only key
    while acquiring."""
    rx, eti, launched, ran = _decode(streams[name], graphs=True)
    ref, ref_eti, ref_launched, ref_ran = _decode(streams[name],
                                                  graphs=False)
    assert rx.device_steps == ref.device_steps >= 13
    assert len(eti) == len(ref_eti) > 0
    assert eti == ref_eti
    _same_state(rx, ref)
    assert ran == ref_ran
    assert ran["acs4"] == ran["traceback4"] == rx.device_steps
    c = rx.graphs.counts
    for k in ("dab_acs4", "dab_traceback4"):
        assert ref_launched[k] == ref.device_steps
        assert launched[k] == c["eager"] + 2 * c["captures"]
    assert len(keys) == rx.device_steps
    assert dict(rx.graphs.counts) == _policy(keys)
    live = [k for k in keys if k == rx.graphs.key]
    assert keys[-len(live):] == live and len(live) >= 11
    assert rx.graphs.key[3][0] == ("ensemble", rx._decode.decode_config())


@pytest.mark.gpu
def test_reconfiguration_recaptures_and_drops_old_graphs(cuda, keys):
    """A change of sub-channel organisation mid-stream: a new key runs
    op by op, then captures and replays, the old graphs are freed, and
    the ETI equals the op-by-op receiver's."""
    ens1 = S.closed_loop_ensemble()
    ens2 = Ensemble(eid=ens1.eid, label="TPU DAB",
                    subchannels=(Subchannel.eep(3, 96, 2, "B", 64),))
    rng = np.random.default_rng(SEED)
    x1, _ = S.modulate(ens1, 22, rng)
    x2, _ = S.modulate(ens2, 40, rng)
    rx = R.DabReceiver(n_frames=N_FRAMES, device="cuda")
    ref = R.DabReceiver(n_frames=N_FRAMES, device="cuda")
    ref.graphs = None
    eti = rx.feed(x1)
    ref_eti = ref.feed(x1)
    key1 = rx.graphs.key
    assert rx.graphs.counts["captures"] >= 1
    old = weakref.ref(rx.graphs._graphs[0][1]["fib_bytes"])
    eti += rx.feed(x2)
    ref_eti += ref.feed(x2)
    assert rx.ensemble.subchannels == ens2.subchannels
    assert eti == ref_eti and len(eti) > 0
    _same_state(rx, ref)
    assert rx.graphs.key != key1 and rx.graphs.key == keys[-1]
    assert dict(rx.graphs.counts) == _policy(keys)
    assert keys[-3:] == [rx.graphs.key] * 3     # captured, then replayed
    gc.collect()
    assert old() is None


@pytest.mark.gpu
def test_foreign_rings_give_eager_bytes(cuda, streams):
    """Rings and a counter that are not the cache's static set (as a
    restore or the autoprobe's rewind hands them over) are copied in: the
    replay gives the op-by-op chain's bytes and rings, and leaves the
    rings it was given as they were."""
    u8 = streams["flagship"]
    rx, *_ = _decode(u8[: 2 * 64 * C.MODE_I.frame_size], graphs=True)
    assert rx.graphs.counts["replays"] >= 3
    x = rx._upload(u8[-2 * R.block_samples(BLOCK):])
    kw = dict(ensemble=rx._decode.decode_config(), n_frames=BLOCK)
    given = {k: v.clone() for k, v in rx._rings.items()}
    kept = {k: v.clone() for k, v in given.items()}
    cif = rx._cif_count.clone()
    replays = rx.graphs.counts["replays"]
    out, rings, cif_next = R.process_block(x, given, cif, **kw,
                                           graphs=rx.graphs)
    got = R.to_host(out)
    want_out, want_rings, want_cif = R.process_block(x, kept, cif, **kw)
    want = R.to_host(want_out)
    assert rx.graphs.counts["replays"] == replays + 1
    np.testing.assert_array_equal(got["fib_bytes"], want["fib_bytes"])
    for k in want["subch"]:
        np.testing.assert_array_equal(got["subch"][k], want["subch"][k])
    assert all(torch.equal(rings[k], want_rings[k]) for k in want_rings)
    assert all(torch.equal(given[k], kept[k]) for k in kept)
    assert int(cif_next) == int(want_cif)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["stale", "flip"])
def test_faults_reach_replayed_blocks(cuda, streams, fault):
    """A ``process_block`` wrapper as ``rxbench/faults.py`` installs:
    ``stale`` hands back the rings it was given, which are then copied
    into the static set, and the ETI equals the op-by-op receiver's
    under the same fault; ``flip`` alters a payload bit of every
    replayed block, so the ETI differs from a clean receiver's."""
    u8 = streams["flagship"]
    clean, clean_eti, *_ = _decode(u8, graphs=True)
    undo = faults.install(fault)
    try:
        rx, eti, *_ = _decode(u8, graphs=True)
        ref, ref_eti, *_ = _decode(u8, graphs=False)
    finally:
        undo()
    assert rx.graphs.counts["replays"] >= 9
    assert eti == ref_eti
    _same_state(rx, ref)
    assert len(eti) == len(clean_eti)
    assert sum(a != b for a, b in zip(eti, clean_eti)) > 0
