"""The port's cross-process half against the JAX package (CPU).

Two ranks of ``tests/torch_distributed_worker.py`` (no JAX) join a
``gloo`` group through ``init_multihost`` on a free localhost port; each
zeroes the samples its cells do not own and gathers the result with
``gather_span``.  The JAX side runs here, in the pytest process, on the
8-device virtual CPU mesh of ``tests/conftest.py``, as
``tests/test_torch_timeblock.py`` runs it: bytes exact, floats within
``atol=2e-4, rtol=1e-4``.  Against the one-process port every leaf is
equal.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dabtools_tpu.parallel.channel import channel_parallel_block as jcpb
from dabtools_tpu.parallel.mesh import make_receiver_mesh as jmesh
from dabtools_tpu_torch.constants import MODE_I
from dabtools_tpu_torch.models.receiver import to_host
from dabtools_tpu_torch.parallel import channel as tchannel
from dabtools_tpu_torch.parallel.mesh import (
    init_multihost,
    make_receiver_mesh,
)
from dabtools_tpu_torch.parallel.timeblock import (
    halo_sizes,
    timeblock_receiver,
)
from tests.test_closed_loop import build_ensemble, modulate
from tests.test_torch_timeblock import (
    FLOATS,
    TOL,
    _assert_parity,
    _both,
    _port,
    _span,
    _streams,
)
from tests.torch_distributed_worker import MESH_KWARGS, launch

N_TIME, F_OWN, WARMUP = 4, 6, 5
G0 = WARMUP + 1

torch.set_num_threads(2)


def _assert_equal_trees(got: dict, want: dict) -> None:
    """Every leaf equal, as tensors (``torch.equal``)."""
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_equal_trees(got[k], v)
        else:
            assert torch.equal(torch.from_numpy(np.asarray(got[k])),
                               torch.from_numpy(np.asarray(v))), k


def _span_case(tmp_path, case, seed, zero_prefix=False):
    """The 2 x 4 span of ``test_timeblock_matches_jax`` (seed ``seed``)
    through JAX, the one-process port and two worker ranks laid out as
    ``case``: (JAX out, one-process out, [each rank's gathered out],
    [each rank's info], modulator payload)."""
    ens = build_ensemble()
    x, payload = modulate(ens, G0 + N_TIME * F_OWN + 1, seed=seed)
    span, prefix, suffix = _span(x, G0, N_TIME, F_OWN, WARMUP)
    if zero_prefix:
        prefix = np.zeros_like(prefix)
    jout, tout = _both(ens, 2, N_TIME, span, prefix, suffix, G0,
                       frames_per_shard=F_OWN, warmup_frames=WARMUP)
    ranks = launch(tmp_path, case, _port(ens), x=span, prefix=prefix,
                       suffix=suffix, g0=G0, f_own=F_OWN, warmup=WARMUP)
    return (jout, tout, [r["out"] for r, _ in ranks],
            [info for _, info in ranks], payload)


def test_span_split_across_ranks_matches_jax(tmp_path):
    """Shards 0-1 on rank 0 and 2-3 on rank 1: the halos of both channels
    cross ranks in both directions.  The gathered span equals the JAX
    8-device mesh, the one-process port and the modulator's payload,
    and each rank made one Viterbi dispatch for its 4 cells."""
    jout, tout, got, infos, payload = _span_case(tmp_path, "span_split", 55)
    for r, info in enumerate(infos):
        assert info["cells"] == [[c, i] for c in range(2)
                                 for i in (2 * r, 2 * r + 1)]
        assert len(info["dispatches"]) == 1
    for g in got:
        _assert_parity(jout, g)
        _assert_equal_trees(g, tout)
        for c in range(2):
            for j in range(N_TIME * F_OWN * 4):
                assert (g["subch"]["1"][c, j].tobytes()
                        == payload[1][G0 * 4 + j - 15].tobytes())


def test_span_rank_major_matches_jax(tmp_path):
    """The JAX worker's layout: each rank's 4 devices, gathered
    rank-major into a (2, 4) mesh, one channel row per rank; no halo
    crosses ranks."""
    jout, tout, got, infos, _ = _span_case(tmp_path, "span_rank_major", 55)
    for r, info in enumerate(infos):
        assert info["cells"] == [[r, i] for i in range(N_TIME)]
        assert len(info["dispatches"]) == 1
    for g in got:
        _assert_parity(jout, g)
        _assert_equal_trees(g, tout)


def test_span_split_cold_start_matches_jax(tmp_path):
    """``test_timeblock_cold_start_matches_jax``'s zero prefix (seed 77)
    on the split layout: shards 1-3 equal the JAX receiver's, every
    shard the one-process port's."""
    jout, tout, got, _, payload = _span_case(tmp_path, "span_split", 77,
                                             zero_prefix=True)
    for g in got:
        _assert_parity(jout, g, skip_shards=1, n_time=N_TIME)
        _assert_equal_trees(g, tout)
        for j in range(F_OWN * 4, N_TIME * F_OWN * 4):
            assert (g["subch"]["1"][0, j].tobytes()
                    == payload[1][G0 * 4 + j - 15].tobytes())


def test_channel_rows_across_ranks_match_jax(tmp_path):
    """``test_channel_parallel_mesh_matches_jax``'s 4 streams over a 2 x 2
    mesh with one channel row per rank: each rank decodes its 2 streams
    in one dispatch, and the gathered batch equals the JAX result and the
    one-process port's (rings included)."""
    ens, xs = _streams(4)
    nb = ens.subchannel(1).profile.tx_bits
    jout, _, _ = jcpb(
        jnp.asarray(xs), {"1": jnp.zeros((4, 16, nb))},
        jnp.asarray(0, jnp.int32), ensemble=ens, n_frames=4,
        mesh=jmesh(n_channels=2, n_time=2, devices=jax.devices()[:4]))
    jout = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in jout.items()}
    tout, trings, _ = tchannel.channel_parallel_block(
        torch.from_numpy(xs), {"1": torch.zeros((4, 16, nb))},
        torch.tensor(0, dtype=torch.int32), ensemble=_port(ens), n_frames=4,
        mesh=make_receiver_mesh(n_channels=2, n_time=2,
                                devices=["cpu"] * 4))
    ranks = launch(tmp_path, "channel", _port(ens), x=xs, ring_bits=nb,
                       n_frames=4)
    for r, (res, info) in enumerate(ranks):
        assert info["cells"] == [[2 * r, 0], [2 * r + 1, 0]]
        assert info["dispatches"] == [2 * (16 + 16)]
        assert info["cif"] == 16
        got = res["out"]
        for key in ("null_start", "prs_offset", "fib_bytes"):
            np.testing.assert_array_equal(got[key], jout[key], err_msg=key)
        np.testing.assert_array_equal(got["subch"]["1"][:, 15:],
                                      jout["subch"]["1"][:, 15:])
        for key in ("cfo_carriers", "null_ratio", *FLOATS[:2]):
            np.testing.assert_allclose(got[key], jout[key], err_msg=key,
                                       **TOL)
        _assert_equal_trees(got, to_host(tout))
        _assert_equal_trees(res["rings"], to_host(trings))


def test_mesh_over_two_ranks_matches_jax(tmp_path):
    """Under 2 ranks of 4 devices each, ``make_receiver_mesh`` gives the
    shapes of ``test_mesh_construction_matches_jax``'s JAX meshes, with
    the ranks rank-major as ``jax.devices()`` orders them across
    processes; without a CUDA device anywhere the default mesh raises,
    and so does a mesh that names a rank the group lacks."""
    ranks = launch(tmp_path, "mesh")
    for _, info in ranks:
        for kw, m in zip(MESH_KWARGS, info["meshes"]):
            assert m["shape"] == dict(jmesh(**kw).shape)
            flat = [r for row in m["ranks"] for r in row]
            assert flat == [0] * 4 + [1] * 4, kw
            assert all(d == "cpu" for row in m["devices"] for d in row)
        if not torch.cuda.is_available():
            assert "no CUDA device on any rank" in info["default_error"]
        assert info["rank_error"] == ("mesh cells name ranks [0, 2] but "
                                      "the process group has 2")


@pytest.mark.parametrize("run", range(3))
def test_ranks_exit_cleanly_without_a_teardown(tmp_path, run):
    """Two pairs of ranks at once, each of which calls ``init_multihost``,
    makes one collective and exits with the group alive: both ranks of
    each pair exit 0 and no log holds ``terminate called`` (``launch``
    raises on either), as ``init_multihost``'s exit hook destroys the
    group.  Without the hook a rank aborted at exit in a few percent of
    such launches under load; three runs of two concurrent pairs make
    that show."""
    dirs = [tmp_path / "a", tmp_path / "b"]
    for d in dirs:
        d.mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        pairs = list(ex.map(lambda d: launch(d, "exit"), dirs))
    for ranks in pairs:
        assert [info["ranks"] for _, info in ranks] == [[0, 1], [0, 1]]


@pytest.mark.parametrize("args", [(), ("127.0.0.1:1", 1, 0),
                                  (None, None, None)])
def test_init_multihost_single_process_is_a_no_op(args):
    """As ``jax.distributed`` is left alone for one process."""
    init_multihost(*args)
    assert not dist.is_initialized()


@pytest.mark.parametrize("args,missing", [
    ((None, 2, 0), "coordinator"), (("127.0.0.1:1", 2, None), "process_id")])
def test_init_multihost_needs_coordinator_and_rank(args, missing):
    with pytest.raises(ValueError, match=missing):
        init_multihost(*args, backend="gloo")
    assert not dist.is_initialized()


def test_mesh_naming_other_ranks_needs_a_group():
    """A mesh whose cells name rank 1 is built, but using it without an
    initialized process group raises; a one-process mesh needs none."""
    mesh = make_receiver_mesh(n_channels=1, n_time=2,
                              devices=[(0, "cpu"), (1, "cpu")])
    assert mesh.ranks == ((0, 1),) and mesh.spans_processes
    fn = timeblock_receiver(mesh, _port(build_ensemble()),
                            frames_per_shard=6, warmup_frames=5)
    lh, rh = halo_sizes(5)
    with pytest.raises(RuntimeError, match="no torch.distributed process"):
        fn(*(torch.zeros((1, n), dtype=torch.complex64)
             for n in (2 * 6 * MODE_I.frame_size, lh, rh)), 6)
    with pytest.raises(RuntimeError, match="no torch.distributed process"):
        tchannel.channel_parallel_block(
            torch.zeros((2, 8), dtype=torch.complex64), {},
            torch.tensor(0, dtype=torch.int32), ensemble=None,
            mesh=make_receiver_mesh(n_channels=2, devices=[(0, "cpu"),
                                                           (1, "cpu")]))
    one = make_receiver_mesh(n_channels=2, devices=["cpu"] * 2)
    assert one.ranks == ((0,), (0,)) and not one.spans_processes
    assert one.process_rank() == 0
