"""Process meshes over ``torch.distributed``.

Counterpart of ``dvt_circuits_tpu/parallel/mesh.py``.  The parallelism
axes of the proving stack:

  * ``dp`` — data parallel: independent proofs in a batch
  * ``sp`` — sequence parallel: the NTT / trace row dimension
  * ``tp`` — tensor parallel: trace columns

JAX's ``shard_map`` runs one host program over a mesh of devices.  Here one
process runs per card (SPMD): each rank holds its own shard and ranks meet in
collectives (NCCL on the card, Gloo on the CPU; ``parallel/comm.py``).
``Mesh`` lays the world's ranks out over the axes in C order, as
``np.array(devices).reshape(...)`` does, and creates a process group for
every slice of every axis and for every contiguous range of two or more
ranks inside a slice (the table-parallel prover's groups).
``dist.new_group`` is collective over the whole world, so every rank creates
every group, in one order.  Nothing here starts a process group at import.

``spawn`` starts ``world`` ranks on one host, the counterpart of building a
mesh over ``jax.devices()``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from dataclasses import dataclass
from math import prod

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels


@dataclass(frozen=True)
class Axis:
    """One rank's view of a mesh axis, or of a range of its ranks: the global
    ranks of this rank's slice in axis order, their process group (None for
    one rank: every collective over it is the identity), this rank's index
    among them (-1 outside the range) and the rank's device."""

    ranks: tuple
    group: object
    index: int
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)


def rank_device(device) -> torch.device:
    """The rank's device: ``cuda`` names the current card explicitly."""
    dev = kernels.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """The initialized world's ranks over named axes, e.g. {"dp": 2,
    "sp": 4}; defaults to a 1-D ``sp`` mesh over every rank."""

    def __init__(self, axes: dict | None = None, device="cuda"):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("Mesh needs an initialized torch.distributed process group")
        world, self.rank = dist.get_world_size(), dist.get_rank()
        axes = dict(axes) if axes is not None else {"sp": world}
        if not axes or prod(axes.values()) != world:
            raise ValueError(f"mesh axes {axes} need {prod(axes.values())} ranks, "
                             f"the world has {world}")
        self.shape = axes
        self.axis_names = tuple(axes)
        self.devices = np.arange(world).reshape(*axes.values())  # the rank grid
        self.device = rank_device(device)
        self._coords = [int(c) for c in np.argwhere(self.devices == self.rank)[0]]
        self._groups: dict = {}
        for i, size in enumerate(axes.values()):
            for line in np.moveaxis(self.devices, i, -1).reshape(-1, size).tolist():
                for start in range(size):
                    for stop in range(start + 2, size + 1):
                        self._group(tuple(line[start:stop]))
                self._group(tuple(line))  # an axis of one rank keeps a group too

    def _group(self, ranks: tuple):
        if ranks not in self._groups:
            self._groups[ranks] = dist.new_group(list(ranks))
        return self._groups[ranks]

    def _line(self, name: str) -> tuple:
        i = self.axis_names.index(name)
        idx = tuple(self._coords[:i]) + (slice(None),) + tuple(self._coords[i + 1 :])
        return tuple(int(r) for r in self.devices[idx])

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (0 on an axis the mesh
        lacks, which has size 1)."""
        return self._coords[self.axis_names.index(name)] if name in self.shape else 0

    def axis(self, name: str) -> Axis:
        """This rank's slice of axis ``name``; an axis the mesh lacks has
        this rank alone."""
        if name not in self.shape:
            return Axis((self.rank,), None, 0, self.device)
        line = self._line(name)
        return Axis(line, self._groups[line], line.index(self.rank), self.device)

    def sub_axis(self, name: str, start: int, length: int) -> Axis:
        """Ranks [start, start + length) of this rank's slice of ``name``."""
        line = self.axis(name).ranks[start : start + length]
        if len(line) != length or length < 1:
            raise ValueError(f"ranks [{start}, {start + length}) lie outside axis {name!r}")
        group = self._groups[line] if length > 1 else None
        index = line.index(self.rank) if self.rank in line else -1
        return Axis(line, group, index, self.device)


_WORLD: dict = {}


def world_mesh(device="cuda") -> Mesh:
    """The 1-D ``sp`` mesh over the whole initialized world, made once per
    process group and device (``prove_circuit``'s sharded path)."""
    dev = rank_device(device)
    hit = _WORLD.get(dev)
    if hit is None or hit[0] is not dist.group.WORLD:
        hit = _WORLD[dev] = (dist.group.WORLD, Mesh(None, dev))
    return hit[1]


# ---------------------------------------------------------------------------
# Spawning ranks on one host
# ---------------------------------------------------------------------------


def _rank_main(rank, world, fn, args, backend, device, store_path, timeout, out_path):
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = (True, fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        result = (False, traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    if not result[0]:
        raise SystemExit(1)


def spawn(fn, world: int, backend: str = "nccl", device="cuda", timeout: float = 600,
          args: tuple = ()) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks of one host, each in
    its own process with the process group initialized (rendezvous through a
    ``FileStore`` in a temporary directory; one card a rank on ``cuda``, one
    thread a rank on the CPU); returns their results in rank order.  ``fn``
    and ``args`` are pickled, so ``fn`` lives at a module's top level.  A
    rank that raises or exits, or a run past ``timeout`` seconds, stops
    every rank and raises."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dvt-spawn-") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, fn, args, backend, str(device),
                                   os.path.join(tmp, "store"), timeout, outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                timed_out = time.monotonic() > deadline
                if timed_out:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for out in outs:
            if os.path.exists(out):
                with open(out, "rb") as f:
                    results.append(pickle.load(f))
            else:
                results.append(None)
    # a rank's own traceback first; else the first rank that did not finish
    bad = [r for r, res in enumerate(results) if res is not None and not res[0]]
    bad += [r for r, res in enumerate(results) if res is None]
    if bad:
        r = bad[0]
        reason = results[r][1] if results[r] is not None else (
            f"exit code {procs[r].exitcode}"
            + (f" (stopped at the {timeout} s limit)" if timed_out else ""))
        raise RuntimeError(f"rank {r} of {world} failed: {reason}")
    return [value for _, value in results]
