"""The rest of the JAX package's closed-loop set through the port, held
against the JAX receiver (CPU).

- Full capacity (``tests/test_full_capacity.py``): the flagship 9 x 128
  kbit/s mux, 12 frames, seed 123: ETI identical to the JAX receiver's
  and every one of the 9 sub-channels the modulator's.
- Numerics (``tests/test_numerics_guard.py``): the JAX test runs
  ``process_block`` under ``jax_debug_nans``; here a ``TorchDispatchMode``
  fails on any non-finite float or complex output of any op inside the
  port's ``process_block``, on 6 frames of signal and on all-zero input,
  and on zeros every output leaf equals the JAX one.
- UEP (``tests/test_uep_mechanism.py``): a synthetic 32 kbit/s P3
  profile registered in both packages' tables (each package has its
  own), then the closed loops of that file, ETI identical to the JAX
  receiver's; then a mux that signals the non-bundled 192 kbit/s P2 row,
  through the port alone (the JAX receiver peaks at ~52 GB RSS there),
  held to that test's outcome (marked ``slow``: see the test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from dabtools_tpu import constants as C
from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.fic.config import Ensemble, Subchannel
from dabtools_tpu.models import receiver as jrx
from dabtools_tpu.tables import puncturing as JP
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.ops.fec import init_deinterleave_ring
from dabtools_tpu_torch.tables import puncturing as TP
from tests.test_closed_loop import build_ensemble, modulate
from tests.test_torch_receiver import _port
from tests.test_torch_robustness import _both

torch.set_num_threads(2)


def _assert_payloads(rx, eti, payload_bytes, subchids):
    frames = list(EtiParser().feed(b"".join(eti)))
    assert frames
    a = rx._activation_cif
    for k, f in enumerate(frames):
        assert f.header_crc_ok and f.mst_crc_ok
        for sc in subchids:
            assert f.subchannel_data(sc) == \
                payload_bytes[sc][a + k].tobytes(), (k, sc)


# ------------------------------------------------------------ full capacity
def test_flagship_full_mux_matches_jax():
    from __graft_entry__ import _flagship_ensemble
    ens = _flagship_ensemble()
    assert sum(s.size_cus for s in ens.subchannels) == 864
    x, payload_bytes = modulate(ens, 12, seed=123)
    jr, je, tr, te = _both(x)
    assert tuple(te) == tuple(je)
    assert len(te) >= 8
    assert tr.ensemble.subchannels == _port(ens).subchannels
    assert len(tr.ensemble.services) == 9
    for f in EtiParser().feed(b"".join(te)):
        assert set(f.streams) == set(range(9))
    _assert_payloads(tr, te, payload_bytes, range(9))


# ------------------------------------------------------------------ numerics
class _FiniteGuard(TorchDispatchMode):
    """Fails on the first op whose float or complex output holds a NaN or
    an infinity; counts the ops it checked."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and not bool(torch.isfinite(t).all())):
                raise AssertionError(f"{func} gave a non-finite value")
        self.ops += 1
        return out


def _guarded_block(x, rings, ensemble):
    guard = _FiniteGuard()
    with guard:
        out, _, _ = trx.process_block(
            torch.from_numpy(x), rings, torch.tensor(0, dtype=torch.int32),
            ensemble=ensemble, n_frames=4)
    assert guard.ops > 100
    return trx.to_host(out)


def test_process_block_is_finite_on_signal():
    """6 frames of the closed-loop signal, 4-frame block."""
    ens = _port(build_ensemble())
    x, _ = modulate(build_ensemble(), 6, seed=0)
    rings = {str(s.subchid): init_deinterleave_ring(s.profile.tx_bits,
                                                    "cpu")
             for s in ens.subchannels}
    out = _guarded_block(x[:trx.block_samples(4)], rings, ens)
    assert np.isfinite(out["cfo_carriers"]).all()


def test_process_block_is_finite_on_silence_and_matches_jax():
    """All-zero input (silence, squelch) through the FIC-only pass: no
    non-finite value, and every output leaf equal to the JAX one."""
    x = np.zeros(trx.block_samples(4), np.complex64)
    out = _guarded_block(x, {}, None)
    jout, _, _ = jrx.process_block(jnp.zeros(x.size, jnp.complex64), {},
                                   jnp.asarray(0, jnp.int32), ensemble=None,
                                   n_frames=4)
    jout = {k: np.asarray(v) for k, v in jout.items()
            if not isinstance(v, dict)}
    flat = {k: v for k, v in out.items() if not isinstance(v, dict)}
    assert set(flat) == set(jout)
    for k, v in jout.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert not out["subch"] and not out["subch_metric"]


# ----------------------------------------------------------------------- UEP
@pytest.fixture
def synthetic_uep_profile():
    """``tests/test_uep_mechanism.py``'s synthetic (32 kbit/s, P3) row,
    registered in the JAX package's table and in the port's; both
    restored after."""
    saved = {P: P.UEP_PROFILES.get((32, 3)) for P in (JP, TP)}
    regions = ((3, 8), (6, 6), (12, 4), (3, 2))
    pad = 24 * C.CU_BITS - JP.PuncturingProfile(
        "probe", regions=regions).tx_bits
    profs = [P.register_uep_profile(32, 3, regions, padding_bits=pad)
             for P in (JP, TP)]
    assert profs[0].mask().tobytes() == profs[1].mask().tobytes()
    yield profs[1]
    for P, prof in saved.items():
        if prof is None:
            del P.UEP_PROFILES[(32, 3)]
        else:
            P.UEP_PROFILES[(32, 3)] = prof


def test_uep_subchannel_closed_loop_matches_jax(synthetic_uep_profile):
    """``test_uep_subchannel_closed_loop``: the synthetic row at table
    index 2, 14 frames, seed 42."""
    ens = Ensemble(eid=0x0EBB, label="UEP TEST",
                   subchannels=(Subchannel.uep(7, 0, table_index=2),))
    x, payload_bytes = modulate(ens, 14, seed=42)
    jr, je, tr, te = _both(x)
    assert tuple(te) == tuple(je)
    got = tr.ensemble.subchannels[0]
    assert (got.protection_type, got.uep_table_index) == ("UEP", 2)
    assert got.profile.mask().tobytes() == \
        synthetic_uep_profile.mask().tobytes()
    _assert_payloads(tr, te, payload_bytes, (7,))


def test_bundled_uep_row_closed_loop_matches_jax(synthetic_uep_profile):
    """``test_bundled_uep_row_closed_loop``: the bundled 128 kbit/s P3
    row (Table 31 index 35), 14 frames, seed 5, with the synthetic row
    registered beside it."""
    assert JP.UEP_TABLE_31[35] == TP.UEP_TABLE_31[35] == (96, 3, 128)
    ens = Ensemble(eid=0x0EBC, label="UEP128",
                   subchannels=(Subchannel.uep(3, 0, table_index=35),))
    x, payload_bytes = modulate(ens, 14, seed=5, payload_subchids=(3,))
    jr, je, tr, te = _both(x)
    assert tuple(te) == tuple(je)
    _assert_payloads(tr, te, payload_bytes, (3,))


# Alone it peaks at 4.9 GB RSS and runs ~170 s (the port's UEP autoprobe
# decodes every candidate row with the plain Viterbi on the CPU); beside
# the JAX package's twin (~53 GB) in a 6-worker run on a 62 GB host it
# got that test OOM-killed in both whole runs that had it, so it runs
# with the slow set.
@pytest.mark.slow
def test_unavailable_uep_subchannel_skipped():
    """``test_unavailable_uep_subchannel_skipped`` on the port alone: a
    mux signalling the non-bundled 192 kbit/s P2 row beside an EEP
    sub-channel.  The EEP sub-channel decodes exactly and the UEP one is
    absent from every frame's STC."""
    from dabtools_tpu_torch.fic.fig import build_fibs_for_ensemble
    from dabtools_tpu_torch.mod.modulator import Modulator, SubchannelSource
    from dabtools_tpu_torch.fic import config as T
    assert TP.UEP_TABLE_31[46] == (168, 2, 192)
    eep = T.Subchannel.eep(1, 0, 3, "A", 64)
    uep = T.Subchannel.uep(9, 48, table_index=46)
    assert not uep.decodable and eep.decodable
    ens = T.Ensemble(
        eid=0x0EBD, label="MIXED", subchannels=(eep, uep),
        services=(T.Service(sid=0x77, components=(
            T.ServiceComponent(tmid=0, subchid=1),)),))
    n_frames = 14
    rng = np.random.default_rng(11)
    payload = np.unpackbits(rng.integers(
        0, 256, (n_frames * C.MODE_I.n_cifs, eep.data_bytes),
        dtype=np.uint8), axis=-1)
    mod = Modulator([SubchannelSource(eep.start_cu, eep.profile)])
    x = mod.frames(n_frames, lambda f: build_fibs_for_ensemble(ens, f),
                   lambda f, i: payload[f * 4:(f + 1) * 4])

    rx = trx.DabReceiver(n_frames=4, device="cpu")
    eti = rx.feed(x)
    assert rx.ensemble is not None
    assert {s.subchid for s in rx.ensemble.subchannels} == {1, 9}
    assert {s.subchid for s in rx._decode.subchannels} == {1}
    assert len(eti) > 0
    payload_bytes = np.packbits(payload, axis=-1)
    a = rx._activation_cif
    for k, f in enumerate(EtiParser().feed(b"".join(eti))):
        assert set(f.streams) == {1}
        assert f.subchannel_data(1) == payload_bytes[a + k].tobytes(), k
