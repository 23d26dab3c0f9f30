"""The two-process tests of the port's cross-process half
(``tests/test_torch_multiprocess.py``, and ``tests/test_torch_kernels.py``
on the card): :func:`launch` starts two ranks of this script, each of
which runs :func:`main`.  It imports no JAX.

    PYTHONPATH=. python tests/torch_distributed_worker.py \
        RANK PORT CASE INPUT.npz OUTDIR DEVICE

Both ranks join a ``gloo`` group with ``init_multihost`` on
``127.0.0.1:PORT`` and run CASE on DEVICE (``cpu``, or ``cuda:0`` for
both ranks on one card):

* ``span_split``: the 2 x 4 time-block span with shards 0-1 on rank 0
  and 2-3 on rank 1, so that the halos of both channels cross ranks in
  both directions;
* ``span_rank_major``: the same span on the mesh every rank's devices
  make, rank-major: one channel row per rank;
* ``channel``: ``channel_parallel_block`` of 4 streams over a 2 x 2 mesh,
  one channel row per rank;
* ``mesh``: the shapes and ranks of ``make_receiver_mesh`` meshes;
* ``exit``: one ``all_gather_object`` of the ranks, then an exit with
  the group alive: ``init_multihost``'s exit hook is its only teardown.

Every other case ends with ``dist.barrier()`` and
``dist.destroy_process_group()``.

Each rank zeroes the samples of ``x`` (and the prefix or suffix) that
its cells do not own, so a halo it read locally would show; writes what
``gather_span`` gives it to ``OUTDIR/rank<RANK>.pt`` (``torch.save``),
and what it saw to ``OUTDIR/rank<RANK>.json``: the cells it decoded and
its Viterbi dispatches and K1/K2 launches.  A rank that exits non-zero
(a signal included) or whose log holds ``terminate called`` (a C++
abort at exit) fails :func:`launch`.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.models.receiver import to_host
from dabtools_tpu_torch.ops import cudalib
from dabtools_tpu_torch.parallel import channel as tchannel
from dabtools_tpu_torch.parallel.mesh import (
    gather_span,
    init_multihost,
    make_receiver_mesh,
)
from dabtools_tpu_torch.parallel.timeblock import timeblock_receiver

MESH_KWARGS = [{}, {"n_time": 4}, {"n_channels": 2},
               {"n_channels": 4, "n_time": 2},
               {"n_channels": 8, "n_time": 1}]
REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 240                 # both ranks' whole runs, from the spawn


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(outdir: pathlib.Path, case: str, ensemble=None,
           device: str = "cpu", **arrays) -> list:
    """Run ``case`` on two ranks (``ensemble`` and ``arrays`` are its
    inputs); each rank's (gathered result on the host, info).  Raises
    if a rank fails or outlasts ``TIMEOUT_S``; kills both then."""
    inputs = outdir / "inputs.npz"
    if ensemble is not None:
        np.savez(inputs, ensemble=json.dumps(ensemble.to_dict()), **arrays)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), port, case, str(inputs),
         str(outdir), device], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode or "terminate called" in log:
            raise AssertionError(f"rank {r} failed (exit code "
                                 f"{p.returncode}):\n{log[-3000:]}")
    res = []
    for r in range(2):
        info = json.loads((outdir / f"rank{r}.json").read_text())
        out = outdir / f"rank{r}.pt"
        res.append((to_host(torch.load(out, map_location="cpu"))
                    if out.exists() else None, info))
    return res


def main(argv: list[str]) -> None:
    rank, port, case = int(argv[0]), argv[1], argv[2]
    inputs, outdir = pathlib.Path(argv[3]), pathlib.Path(argv[4])
    dev = torch.device(argv[5])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(2)
    init_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    info: dict = {"rank": rank}
    if case == "exit":
        ranks: list = [None, None]
        dist.all_gather_object(ranks, rank)
        info["ranks"] = ranks
        (outdir / f"rank{rank}.json").write_text(json.dumps(info))
        return
    if case == "mesh":
        meshes = [make_receiver_mesh(devices=["cpu"] * 4, **kw)
                  for kw in MESH_KWARGS]
        info["meshes"] = [{"shape": m.shape, "ranks": m.ranks,
                           "devices": [[str(d) for d in row]
                                       for row in m.devices]}
                          for m in meshes]
        try:
            make_receiver_mesh()
        except ValueError as e:
            info["default_error"] = str(e)
        try:
            make_receiver_mesh(devices=[(0, "cpu"), (2, "cpu")]).process_rank()
        except ValueError as e:
            info["rank_error"] = str(e)
        (outdir / f"rank{rank}.json").write_text(json.dumps(info))
    else:
        _decode_case(rank, case, inputs, outdir, dev, info)
    dist.barrier()
    dist.destroy_process_group()


def _decode_case(rank: int, case: str, inputs: pathlib.Path,
                 outdir: pathlib.Path, dev: torch.device,
                 info: dict) -> None:
    """The ``channel`` and ``span_*`` cases."""
    data = np.load(inputs)
    ens = Ensemble.from_dict(json.loads(str(data["ensemble"])))
    x = torch.from_numpy(data["x"].copy()).to(dev)
    dispatches = []
    real = tchannel.viterbi_decode_ragged

    def counting(softs):
        dispatches.append(sum(s.shape[0] for s in softs))
        return real(softs)

    # the channel batch dispatches in parallel/channel.py, the span
    # through the receiver's pipeline_core
    tchannel.viterbi_decode_ragged = counting
    trx.viterbi_decode_ragged = counting
    if case == "channel":
        mesh = make_receiver_mesh(n_channels=2, devices=[dev] * 2)
        rows = mesh.rows_of(x.shape[0])
        for c in range(x.shape[0]):
            if mesh.ranks[rows[c]][0] != rank:
                x[c] = 0
        nb = int(data["ring_bits"])
        out, rings, cif = tchannel.channel_parallel_block(
            x, {"1": torch.zeros((x.shape[0], 16, nb), device=dev)},
            torch.tensor(0, dtype=torch.int32, device=dev), ensemble=ens,
            n_frames=int(data["n_frames"]), mesh=mesh)
        info["cells"] = sorted(out)
        info["cif"] = int(cif)
        result = {"out": gather_span(out, mesh),
                  "rings": gather_span(rings, mesh)}
    else:
        prefix = torch.from_numpy(data["prefix"].copy()).to(dev)
        suffix = torch.from_numpy(data["suffix"].copy()).to(dev)
        n_ch, n_time = x.shape[0], 4
        if case == "span_split":
            mesh = make_receiver_mesh(n_channels=n_ch, n_time=n_time,
                                      devices=[(i // 2, dev)
                                               for _ in range(n_ch)
                                               for i in range(n_time)])
        else:
            mesh = make_receiver_mesh(n_channels=n_ch, n_time=n_time,
                                      devices=[dev] * n_time)
        shard = x.shape[1] // n_time
        for c in range(n_ch):
            for i in range(n_time):
                if mesh.ranks[c][i] != rank:
                    x[c, i * shard:(i + 1) * shard] = 0
            if mesh.ranks[c][0] != rank:
                prefix[c] = 0
            if mesh.ranks[c][-1] != rank:
                suffix[c] = 0
        fn = timeblock_receiver(mesh, ens,
                                frames_per_shard=int(data["f_own"]),
                                warmup_frames=int(data["warmup"]))
        out = fn(x, prefix, suffix, int(data["g0"]))
        info["cells"] = sorted(out)
        result = {"out": gather_span(out, mesh)}
    info["dispatches"] = dispatches
    info["launches"] = [cudalib.launches["dab_acs4"],
                        cudalib.launches["dab_traceback4"]]
    torch.save(result, outdir / f"rank{rank}.pt")
    (outdir / f"rank{rank}.json").write_text(json.dumps(info))


if __name__ == "__main__":
    main(sys.argv[1:])
