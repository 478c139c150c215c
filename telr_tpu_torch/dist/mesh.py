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
mesh of the whole group, and its collectives (dist/redistribute.py's `_mp`
functions, the runner's object all-gather) move host tensors over gloo.
Each rank's kernels run on its own card (utils/device.py::resolve).
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Tuple

import numpy as np

READS_AXIS = "reads"
LOCI_AXIS = "loci"

# how long a collective may wait for the other ranks before it fails: a rank
# that died must end the run, never hang it
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the torch.distributed process group of `num_processes` ranks
    whose rank 0 listens at `coordinator` ("host:port"); a no-op for a
    single process.  Collectives go over gloo on host tensors, whatever
    device the rank's kernels use."""
    if backend == "nccl":
        raise NotImplementedError(
            "NCCL collectives are not ported: they need two or more cards "
            "(ROADMAP, queue 1, the item \"NCCL across >= 2 cards\"); use "
            "backend=\"gloo\"")
    if backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}; the port runs its "
                         "collectives over gloo")
    if not num_processes or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("a process group of several ranks needs the "
                         "coordinator's address and this process' rank")
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


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
