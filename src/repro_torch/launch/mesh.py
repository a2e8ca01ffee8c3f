"""The cloud mesh on ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh of shape ``(data, model)`` is ``data * model`` ranks, one process
each, that run the same program (SPMD).  Rank ``r`` sits at
``(r // model, r % model)``: a model row shares one replica's tensor
shards, a data column one shard's replicas.  Every rank joins one process
group of the row and one of the column (``CloudMesh.model_axis`` /
``data_axis``), and runs on ``cuda:(r % device_count)`` unless the caller
asks for the CPU.

The backend is NCCL when every rank has a card of its own, else gloo (on
the CPU, and when ranks share a card: NCCL refuses two ranks on one
device).  The collectives the model calls are all ``all_reduce``s
(``launch.sharding``); over gloo a card's tensors are staged through host
memory (``CloudMesh.transport``).

``spawn(fn, world, device=, timeout=)`` starts the ranks with
``torch.multiprocessing`` (start method ``spawn``) around a ``FileStore``
in a temporary directory (no network port), calls ``fn(rank, world,
*args)`` in each, and returns their results in rank order.  If a rank
fails or the deadline passes, every rank is killed and the error is
raised in the caller: a divergence never hangs.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.sharding import AXES, Axis, MeshShape


def backend_for(world: int, device: str) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else gloo."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def ranks_per_card(world: int, device: str) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return -(-world // max(1, torch.cuda.device_count()))


def check_pair(shape) -> Tuple[int, int]:
    try:
        dims = tuple(int(s) for s in shape)
    except (TypeError, ValueError):
        dims = ()
    if len(dims) != 2 or any(d < 1 for d in dims):
        raise ValueError(f"cloud_mesh must be a (data, model) pair of "
                         f"positive ints, got {shape!r}")
    return dims


class CloudMesh:
    """This rank's view of a ``(data, model)`` mesh over the current
    process group: its coordinates, its two axes with their subgroups,
    its device and the group's backend."""

    axis_names = AXES

    def __init__(self, dims: Tuple[int, int], rank: int, world: int,
                 device: torch.device, backend: str,
                 groups: Dict[str, Any]):
        self.dims = dims
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend
        d, m = dims
        self.coords = {"data": rank // m, "model": rank % m}
        staged = backend == "gloo" and device.type == "cuda"
        self.model_axis = Axis(self.coords["model"], m, groups["model"],
                               staged)
        self.data_axis = Axis(self.coords["data"], d, groups["data"], staged)

    @property
    def transport(self) -> str:
        """Where the sums are taken: on the cards (NCCL), or in host
        memory (gloo; a card's tensors staged through it)."""
        if self.backend != "gloo":
            return "device"
        return "host-staged" if self.device.type == "cuda" else "host"

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.dims))

    @property
    def ranks_per_card(self) -> int:
        return ranks_per_card(self.world, str(self.device))

    def describe(self) -> str:
        return (f"mesh={self.dims} backend={self.backend} "
                f"transport={self.transport} "
                f"ranks/card={self.ranks_per_card}")


_MESHES: Dict[tuple, CloudMesh] = {}
# the timeout ``spawn`` gave this rank's process group; its subgroups
# take it too (None: torch's default, for a group started elsewhere)
_TIMEOUT: Optional[datetime.timedelta] = None


def make_cloud_mesh(shape, *, device=None) -> CloudMesh:
    """The cloud mesh of a ``CollmConfig.cloud_mesh`` pair over the
    current process group (cached: the subgroups are made once a
    process).  ``device`` defaults to the rank's card, or the CPU without
    one.  Raises ``ValueError`` for a bad pair, without a process group,
    or when the mesh does not cover the group's ranks."""
    import torch.distributed as dist
    dims = check_pair(shape)
    need = dims[0] * dims[1]
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"cloud_mesh {dims} needs a torch.distributed "
                         f"process group of {need} ranks (start them with "
                         f"repro_torch.launch.mesh.spawn)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if need != world:
        raise ValueError(f"cloud_mesh {dims} needs {need} ranks but the "
                         f"process group has {world}: its world size must "
                         f"be data * model")
    if device is None:
        device = (f"cuda:{rank % torch.cuda.device_count()}"
                  if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    key = (dims, id(dist.group.WORLD), str(device))
    mesh = _MESHES.get(key)
    if mesh is None:
        d, m = dims
        groups: Dict[str, Any] = {}
        # every rank makes every subgroup, in one order
        for i in range(d):
            g = dist.new_group([i * m + j for j in range(m)],
                               timeout=_TIMEOUT)
            if i == rank // m:
                groups["model"] = g
        for j in range(m):
            g = dist.new_group([i * m + j for i in range(d)],
                               timeout=_TIMEOUT)
            if j == rank % m:
                groups["data"] = g
        mesh = _MESHES[key] = CloudMesh(dims, rank, world, device,
                                        dist.get_backend(), groups)
    return mesh


def recording_mesh(shape, device, rank: int = 0) -> CloudMesh:
    """Rank ``rank``'s view of a ``(data, model)`` mesh of no processes:
    both axes are recording axes (``sharding.recording_axis``), whose sums
    are recorded and not communicated.  The dry run's stand-in for a
    rank's groups (``launch/dryrun_collm.py``)."""
    from repro_torch.launch.sharding import RECORDING
    dims = check_pair(shape)
    return CloudMesh(dims, rank, dims[0] * dims[1], torch.device(device),
                     "record", {"model": RECORDING, "data": RECORDING})


def one_at_a_time(mesh: CloudMesh, fn: Callable[[], Any]) -> Any:
    """``fn()`` on every rank: one rank after the other when ranks share a
    card (so that the peaks of building a rank's share, which draws each
    parameter whole, never meet), at once otherwise."""
    import torch.distributed as dist
    if mesh.ranks_per_card <= 1:
        return fn()
    out = None
    for turn in range(mesh.world):
        if turn == mesh.rank:
            out = fn()
            torch.cuda.synchronize(mesh.device)
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def make_debug_mesh(n_devices: int = 1, world: Optional[int] = None
                    ) -> MeshShape:
    """A small ``(data, model)`` shape over at most ``world`` ranks (the
    process group's, or 1): the largest model axis of 4, 2, 1 that
    divides them."""
    if world is None:
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
    n = min(n_devices, world)
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return MeshShape((n // model, model), AXES)


def pod_submeshes(shape) -> Tuple[np.ndarray, np.ndarray]:
    """Split a ``(pod, data, model)`` shape into the (data, model) rank
    grids of the edge pod and the cloud pod (pods 0 and 1): the two-tier
    deployment."""
    dims = tuple(int(s) for s in shape)
    if len(dims) != 3 or dims[0] < 2:
        raise ValueError(f"pod_submeshes needs a (pod, data, model) shape "
                         f"with pod >= 2, got {shape!r}")
    ranks = np.arange(int(np.prod(dims))).reshape(dims)
    return ranks[0], ranks[1]


# --------------------------------------------------------------------------
# starting the ranks
# --------------------------------------------------------------------------
def _rank_main(rank: int, fn: Callable, world: int, device: str,
               backend: str, store_path: str, outdir: str, timeout: float,
               threads: Optional[int], args: tuple) -> None:
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    if backend == "gloo":
        # one host: gloo's pairs on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    global _TIMEOUT
    _TIMEOUT = datetime.timedelta(seconds=timeout)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=_TIMEOUT)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, device: str = "cuda",
          timeout: float = 600.0, args: Sequence[Any] = (),
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` new processes joined in
    one process group (``backend_for(world, device)``) and return the
    ranks' results, in rank order (``torch.save``-able values).  Each
    process group, and the whole call, has ``timeout`` seconds; past it,
    or when a rank fails, every rank is killed and the error raised
    here.  ``threads`` sets each rank's ``torch.set_num_threads``."""
    import torch.multiprocessing as mp
    backend = backend_for(world, device)
    tmp = tempfile.mkdtemp(prefix="cloud_mesh_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, device, backend,
                              os.path.join(tmp, "store"), tmp, timeout,
                              threads, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world} ranks did not finish "
                                       f"within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
