"""A (data, model, seq) mesh over the ranks of a ``torch.distributed`` group.

Counterpart of ``dvdx_tpu/parallel/mesh.py``. Axes:

  data  -- independent videos (data parallelism);
  model -- parameter sharding (the FSDP / ZeRO-3 analog, ``parallel.sharding``);
  seq   -- frames or chunks (chunk parallelism, and exact context parallelism
           with ring / Ulysses temporal attention, ``ops.ring_attention``).

Rank r sits at ``np.unravel_index(r, shape)``, the JAX mesh's device order.
Every collective of the strategies runs on a subgroup of ranks that share
their other coordinates: ``Mesh.group(("model",))`` for the parameter
all-gathers, ``("seq",)`` for the ring, ``("data", "seq")`` for the chunk
stitch. ``make_mesh`` builds the subgroups of an initialised default group
(every rank creates every subgroup, in one order, as ``new_group`` requires);
``single_device_mesh`` is the (1, 1, 1) mesh of one process with no group at
all, on which every strategy runs without a collective.

The backend follows the device: NCCL for CUDA, gloo for the CPU
(``init_process_group``). Nothing here picks the device for the caller.
``run_ranks`` starts one process per rank and joins them with a deadline.
"""

from __future__ import annotations

import datetime
import itertools
import os
import socket
import tempfile
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model", "seq")
# the subgroups the strategies use; a size-1 axis still gets its group when
# a process group exists, so a one-rank NCCL run goes through the collectives
GROUP_AXES = (("data",), ("model",), ("seq",), ("data", "seq"))


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(init_method: str, world_size: int, rank: int, device,
                       timeout_s: float = 600.0) -> None:
    """The default group with the backend of ``device`` (NCCL for CUDA, gloo
    for the CPU). ``init_method`` is ``tcp://localhost:<port>`` or
    ``file://<path>``; ``timeout_s`` bounds every collective, so a rank whose
    peer died fails instead of waiting for ever."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device), init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Mesh:
    """A (data, model, seq) factorisation of the default group's ranks.
    ``shape`` maps axis name -> size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, shape: Sequence[int], device, rank: int = 0,
                 groups: Optional[Dict[tuple, object]] = None,
                 members: Optional[Dict[tuple, list]] = None):
        if len(shape) != 3:
            raise ValueError(f"mesh shape {tuple(shape)} is not (data, model, seq)")
        self.shape = dict(zip(AXES, (int(s) for s in shape)))
        self.device = torch.device(device)
        self.rank = rank
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, tuple(shape)))))
        self._groups = groups or {}
        self._members = members or {}

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.shape[a] for a in AXES)

    @property
    def world_size(self) -> int:
        return int(np.prod(self.dims))

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position along the flattened ``axes`` (row-major)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Sequence[str]):
        """The subgroup over ``axes`` that holds this rank, or None where the
        mesh has no process group (``single_device_mesh``)."""
        return self._groups.get(tuple(axes))

    def global_ranks(self, axes: Sequence[str]) -> list:
        """Global ranks of this rank's subgroup over ``axes``, in order."""
        return self._members.get(tuple(axes), [self.rank])

    def __repr__(self) -> str:
        return f"Mesh({self.dims}, rank={self.rank}, device={self.device})"


def make_mesh(shape: Optional[Tuple[int, int, int]] = None, device=None) -> Mesh:
    """The (data, model, seq) mesh over the initialised default group:
    ``shape`` None is (1, 1, world_size). ``device`` defaults to this rank's
    card for an NCCL group and the CPU for a gloo group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(parallel.mesh.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = tuple(shape) if shape is not None else (1, 1, world)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not use {world} ranks")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    ranks = np.arange(world).reshape(shape)
    groups, members = {}, {}
    for axes in GROUP_AXES:
        keep = [AXES.index(a) for a in axes]
        other = [i for i in range(3) if i not in keep]
        # one subgroup per coordinate of the other axes, in a fixed order
        for fixed in itertools.product(*[range(shape[i]) for i in other]):
            index = [slice(None)] * 3
            for ax, c in zip(other, fixed):
                index[ax] = c
            sub = ranks[tuple(index)].reshape(-1).tolist()
            g = dist.new_group(sub)
            if rank in sub:
                groups[axes], members[axes] = g, sub
    return Mesh(shape, device, rank, groups, members)


def single_device_mesh(device="cuda") -> Mesh:
    """The (1, 1, 1) mesh of one process; needs no process group."""
    return Mesh((1, 1, 1), device)


def _rank_main(fn, rank: int, world_size: int, init_method: str, device: str,
               out_dir: str, args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    try:
        init_process_group(init_method, world_size, rank, dev, timeout_s=120.0)
        result = fn(rank, world_size, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: tuple = (), *, device,
              timeout_s: float = 60.0, workdir: Optional[str] = None) -> list:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` fresh
    processes joined in one group on ``device``, which the caller names
    ("cuda": NCCL, rank r on card r; "cpu": gloo), rendezvous through a file
    in ``workdir``. Returns each rank's
    result (``torch.save``-able), in rank order. Raises, and kills every
    rank, when one fails or the ranks outlive ``timeout_s``: a rank whose
    peer died fails its collective at the group's timeout instead of
    hanging. ``fn`` must be importable by name (spawned processes import
    it)."""
    import torch.multiprocessing as mp

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="dvdx_ranks_")
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, "rendezvous")
    if os.path.exists(init_file):
        os.unlink(init_file)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, f"file://{init_file}", str(device),
                               workdir, tuple(args)))
             for r in range(world_size)]
    import time

    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_ranks: ranks still running after {timeout_s:.0f} s")
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a rank failed: the others would wait on it
            time.sleep(0.05)
        errors = []
        for r, p in enumerate(procs):
            if p.exitcode not in (None, 0):
                err = os.path.join(workdir, f"rank{r}.err")
                text = open(err).read() if os.path.exists(err) else ""
                errors.append(f"rank {r} exited {p.exitcode}\n{text[-3000:]}")
        if errors:
            raise RuntimeError("run_ranks: " + "\n".join(errors))
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if own:
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)
