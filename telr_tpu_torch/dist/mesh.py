"""Device-mesh setup and sharding helpers.

The reference is single-node multiprocessing (SURVEY.md §2c); the
distributed design here is first-class:

  * axis "reads" — data parallelism over read batches (the reference index is
    replicated per host, reads stream across the mesh),
  * axis "loci"  — locus parallelism for batched per-locus work (assembly,
    AF realignment, liftover), fed by an all-to-all redistribution of
    (locus, read) pairs after SV detection.

A Mesh is a ("reads", "loci") grid of torch devices driven by ONE process:
each shard's tensors live on its own device and the steps in dist/ loop over
the shards.  On CUDA the shards are distinct cards; with device="cpu" every
shard is the CPU, which is how the tests run an n-shard mesh on one host.

Several processes (dist/runner.py) join one torch.distributed process group
through `init_distributed`; `process_mesh` is then the one-shard-per-process
mesh of the whole group.  The group's backend follows the topology: NCCL
where every rank of the host has a card of its own (each rank's collectives
then move tensors on its card, `collective_device`), gloo on host tensors
on the CPU and where ranks share a card.  Each rank's kernels run on card
rank % cards (utils/device.py::resolve).
"""

from __future__ import annotations

import atexit
import datetime
import logging
from typing import Dict, Optional, Tuple

import numpy as np

READS_AXIS = "reads"
LOCI_AXIS = "loci"

# how long a collective may wait for the other ranks before it fails: a rank
# that died must end the run, never hang it
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

logger = logging.getLogger("telr_tpu.dist")


def pick_backend(num_processes: int, device=None,
                 backend: Optional[str] = None) -> str:
    """The backend of a group of `num_processes` ranks, all on this host.

    backend=None follows the topology: "nccl" when the group's device is a
    card (device None or "cuda", and a card is there) and every rank has a
    card of its own; "gloo" on the CPU (device="cpu", or no card with
    device None) and where ranks would share a card.  An explicit backend
    is taken as asked; "nccl" without a card for every rank raises."""
    import torch
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; the port runs its "
                         "collectives over gloo or nccl")
    if backend == "gloo":
        return backend
    on_cpu = device is not None and torch.device(device).type == "cpu"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        if on_cpu or cards == 0:
            raise RuntimeError("backend=\"nccl\" needs a CUDA card for every "
                               "rank; this host has none")
        if num_processes > cards:
            raise RuntimeError(f"backend=\"nccl\" needs a card for every "
                               f"rank: {num_processes} ranks, {cards} cards")
        return backend
    if device is not None and not on_cpu and cards == 0:
        raise RuntimeError(
            f"no CUDA card found for device={device!r}; to run on the CPU "
            "ask for it: device=\"cpu\"")
    return "nccl" if not on_cpu and 0 < num_processes <= cards else "gloo"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     device=None) -> None:
    """Join the torch.distributed process group of `num_processes` ranks,
    all on this host, whose rank 0 listens at `coordinator` ("host:port");
    a no-op for a single process.  The backend is `pick_backend`'s for the
    group's `device` (None: the card when there is one).  Under NCCL each
    rank first takes card rank % cards as its current device, where its
    collectives run; a failed NCCL start or collective ends the run, with
    no retry over gloo."""
    n = num_processes or 1
    backend = pick_backend(n, device, backend)
    if n <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("a process group of several ranks needs the "
                         "coordinator's address and this process' rank")
    import torch
    import torch.distributed as dist
    kwargs = {}
    card = None
    if backend == "nccl":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout, **kwargs)
    # leave the group while the interpreter is whole: a group torn down in
    # its finalisation can abort the process (seen under gloo on a loaded
    # host: "terminate called without an active exception")
    atexit.register(_leave_group)
    logger.info("rank %d of %d: collectives over %s%s", process_id,
                num_processes, backend,
                f" on {card}" if card is not None else " on host tensors")


def _leave_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def collective_device():
    """Where this rank's collective tensors live: its current card under
    NCCL, the host under gloo and without a process group."""
    import torch
    if _group_initialized():
        import torch.distributed as dist
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _group_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process' rank in the process group (0 without one)."""
    if not _group_initialized():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def process_count() -> int:
    """The process group's size (1 without one)."""
    if not _group_initialized():
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


class Mesh:
    """A (reads, loci) grid of torch devices.  Hashable and comparable by
    its devices and axis names, so step caches can key on it."""

    axis_names: Tuple[str, str] = (READS_AXIS, LOCI_AXIS)

    def __init__(self, devices, axis_names=(READS_AXIS, LOCI_AXIS)):
        import torch
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                           for r in grid):
            raise ValueError("a mesh needs a rectangular, non-empty device "
                             "grid")
        self.devices = tuple(tuple(r) for r in grid)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def flat_devices(self):
        """The devices in row-major order: shard k of a batch split over
        the whole mesh lives on flat_devices()[k]."""
        return [d for row in self.devices for d in row]

    def axis_devices(self, axis: str):
        """One device per index along `axis` (the first of the other axis):
        where shard k of an array split over `axis` alone lives."""
        if axis == self.axis_names[0]:
            return [row[0] for row in self.devices]
        if axis == self.axis_names[1]:
            return list(self.devices[0])
        raise KeyError(axis)

    def _key(self):
        return (tuple(tuple(str(d) for d in r) for r in self.devices),
                self.axis_names)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self._key()[0]})"


def make_mesh(n_devices: Optional[int] = None, loci_parallel: int = 1,
              device=None) -> Mesh:
    """Build a ("reads", "loci") mesh.

    device: None or "cuda" takes cards 0..n-1 and raises when n exceeds
    their number (None also raises when there is no card at all); "cpu",
    which must be asked for, gives n shards that all live on the CPU (n
    defaults to 1 there)."""
    import torch
    from telr_tpu_torch.utils.device import resolve
    dev = resolve(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = n_devices or have
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        devices = [torch.device("cuda", k) for k in range(n)]
    else:
        n = n_devices or 1
        devices = [dev] * n
    if n % loci_parallel != 0:
        raise ValueError("n_devices must be divisible by loci_parallel")
    grid = [devices[r * loci_parallel:(r + 1) * loci_parallel]
            for r in range(n // loci_parallel)]
    return Mesh(grid, (READS_AXIS, LOCI_AXIS))


def process_mesh(device=None) -> Mesh:
    """The ("reads", "loci") mesh of the whole process group: one row per
    rank, row r holding rank r's device (cuda:(r % cards), or the CPU when
    device="cpu" is asked for).  The collectives read its size; the rows
    name where each rank runs."""
    import torch
    from telr_tpu_torch.utils.device import resolve
    dev = resolve(device)
    n = process_count()
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        rows = [[torch.device("cuda", r % cards)] for r in range(n)]
    else:
        rows = [[dev] for _ in range(n)]
    return Mesh(rows, (READS_AXIS, LOCI_AXIS))


def shard_slices(total: int, devices):
    """(slice, device) per shard of a batch of `total` rows cut evenly over
    `devices`."""
    if total % len(devices):
        raise ValueError(f"a batch of {total} does not divide over "
                         f"{len(devices)} shards")
    per = total // len(devices)
    return [(slice(k * per, (k + 1) * per), dev)
            for k, dev in enumerate(devices)]


def pad_to_multiple(a: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    """Pad the batch axis so it divides evenly across mesh shards."""
    n = a.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return a
    pad_widths = [(0, 0)] * a.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(a, pad_widths, constant_values=fill)
