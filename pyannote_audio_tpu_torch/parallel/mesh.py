"""Device meshes and data parallelism.

Counterpart of pyannote_audio_tpu/parallel/mesh.py. The JAX package runs
one process that shards a batch's leading axis over the ``"data"`` axis
of a device mesh. In PyTorch that splits into two idioms, and both read
the same ``Mesh``:

- inference (``Inference(mesh=)``, ``SpeakerDiarization(mesh=)``): one
  process splits each batch into contiguous shards (``shard_batch``, as
  ``P("data")`` does), runs each on its device's replica of the model
  (``replicate``: one module per distinct device, so devices that repeat
  share it) and gathers the outputs on the first device. The copies are
  ``non_blocking``, so one host thread keeps several cards busy;
- training (``Trainer(mesh=)``): ``torch.distributed`` with
  ``DistributedDataParallel``, one process per device. Inside an
  initialised process group ``make_mesh`` spans the group, one device
  per rank.

The collectives are ``all_reduce`` and ``broadcast`` only: gloo takes
CUDA tensors for those two, and two ranks on one card need gloo (NCCL
refuses a duplicate GPU). The JAX module's ``data_sharding`` and
``replicated`` build ``NamedSharding`` objects, which have no torch
meaning; they are not here.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "normalize_device", "pad_to_devices",
           "split_leading", "shard_batch", "gather_shards", "replicate",
           "map_shards", "broadcast_from_host0"]


def normalize_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` is the current card,
    as ``Tensor.to`` reads it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() \
            if torch.cuda.is_available() else 0
        device = torch.device("cuda", index)
    return device


class Mesh:
    """Devices on named axes (``("data",)``), and the process group whose
    ranks hold them, if any. ``devices`` is a numpy object array of
    ``torch.device``, so ``mesh.devices.size`` reads as in JAX."""

    def __init__(self, devices: Sequence[Union[str, torch.device]],
                 axis_names: Tuple[str, ...] = ("data",),
                 shape: Optional[Sequence[int]] = None,
                 group: Optional[Any] = None):
        flat = [normalize_device(d) for d in devices]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        if shape is None:
            shape = (len(flat),) + (1,) * (len(axis_names) - 1)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} does not match the axis "
                             f"names {axis_names}")
        self.devices = grid.reshape(tuple(shape))
        self.axis_names = tuple(axis_names)
        self.group = group

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        return list(self.devices.flat)

    @property
    def distributed(self) -> bool:
        """Does the mesh span the ranks of a process group?"""
        return self.group is not None

    @property
    def rank(self) -> int:
        """This process's rank in the mesh's group (0 without one)."""
        return dist.get_rank(self.group) if self.distributed else 0

    def check_first(self, device: Union[str, torch.device]) -> None:
        """Raise unless ``device`` is the mesh's first device, where an
        ``Inference`` or a pipeline over the mesh lives."""
        if normalize_device(device) != self.device_list[0]:
            raise ValueError(f"{device} is not the first device of {self}")

    @property
    def local_device(self) -> torch.device:
        """This process's device: its rank's, or the first one."""
        return self.device_list[self.rank]

    def __repr__(self) -> str:
        devices = ", ".join(str(d) for d in self.device_list)
        kind = f", {dist.get_backend(self.group)} group" \
            if self.distributed else ""
        return f"Mesh([{devices}], axis_names={self.axis_names}{kind})"


def _rank_device() -> torch.device:
    """The device a rank works on: its current CUDA device (set with
    ``torch.cuda.set_device(local_rank)``) where there is a card, else
    the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def collective_device(group: Optional[Any] = None) -> torch.device:
    """Where a collective's tensors must live: the rank's card under NCCL,
    the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _group_devices(group) -> List[torch.device]:
    """Every rank's device, agreed on with one ``all_reduce``: a (world,
    2) table of (type, index) in which each rank fills its row."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    mine = _rank_device()
    table = torch.zeros(world, 2, dtype=torch.int64,
                        device=collective_device(group))
    table[rank, 0] = 1 if mine.type == "cuda" else 0
    table[rank, 1] = mine.index or 0
    dist.all_reduce(table, group=group)
    return [torch.device("cuda", int(i)) if t else torch.device("cpu")
            for t, i in table.tolist()]


def make_mesh(num_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A mesh over the first ``num_devices`` devices.

    ``devices`` names them for a mesh of one process (``["cpu", "cpu"]``,
    ``["cuda:0", "cuda:0"]``). Without it, inside an initialised process
    group the mesh spans the default group with each rank's current
    device, and otherwise every visible CUDA device; without a card that
    raises."""
    if devices is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        world = dist.get_world_size(group)
        if num_devices not in (None, world):
            raise ValueError(f"a process group of {world} ranks spans "
                             f"{world} devices, not {num_devices}")
        return Mesh(_group_devices(group), axis_names, shape, group=group)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh spans the visible CUDA devices and none is "
                "available: pass devices= (e.g. [\"cpu\", \"cpu\"])")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(devices, axis_names, shape)


def pad_to_devices(n: int, num_devices: int) -> int:
    """Smallest multiple of num_devices >= n (batch divisibility)."""
    return -(-n // num_devices) * num_devices


def _tree_map(fn: Callable, tree):
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t) for t in tree)
    if isinstance(tree, list):
        return [_tree_map(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def split_leading(batch, n: int) -> List:
    """``batch`` (a tensor, an array, or a tuple / list / dict of them)
    as ``n`` contiguous shards of its leading axis (ragged: the first
    ones one longer), each of the same structure."""
    if isinstance(batch, (tuple, list)):
        parts = [split_leading(b, n) for b in batch]
        return [type(batch)(p[i] for p in parts) for i in range(n)]
    if isinstance(batch, dict):
        parts = {k: split_leading(v, n) for k, v in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if batch is None:
        return [None] * n
    if isinstance(batch, np.ndarray):
        return np.array_split(batch, n)
    return list(torch.tensor_split(batch, n))


def _to(tree, device: torch.device):
    """Every tensor of ``tree`` on ``device``, copied ``non_blocking``."""
    return _tree_map(lambda x: x.to(device, non_blocking=True)
                     if isinstance(x, torch.Tensor) else x, tree)


def shard_batch(batch, mesh: Mesh) -> List:
    """The per-device shards of ``batch``'s leading axis, each moved to
    its device (``non_blocking``): what ``P("data")`` lays out."""
    return [_to(shard, device) for shard, device in
            zip(split_leading(batch, mesh.size), mesh.device_list)]


def gather_shards(outputs: List, device: torch.device):
    """Per-shard outputs (tensors, or tuples of them) concatenated on
    ``device``."""
    moved = [_to(out, device) for out in outputs]
    if len(moved) == 1:
        return moved[0]
    if isinstance(moved[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*moved))
    return torch.cat(moved)


def replicate(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One module per mesh slot: ``module`` itself on its own device, a
    ``copy.deepcopy`` on each other distinct device (shared by the slots
    that repeat it). Per-device caches that a copy carries (the LSTM's
    packed weights) are keyed on their device, so they are rebuilt."""
    own = normalize_device(next(module.parameters()).device)
    copies = {own: module}
    for device in mesh.device_list:
        if device not in copies:
            copies[device] = copy.deepcopy(module).to(device)
    return [copies[device] for device in mesh.device_list]


def map_shards(mesh: Mesh, replicas: Sequence, fn: Callable, *args):
    """``fn(replica, *shard_args)`` on each device's contiguous shard of
    ``args``' leading axis, outputs gathered on the mesh's first device.
    Empty shards (a batch shorter than the mesh) are skipped; nothing
    waits for the device."""
    outputs = [fn(replica, *shard) for replica, shard in
               zip(replicas, shard_batch(args, mesh)) if len(shard[0])]
    return gather_shards(outputs, mesh.device_list[0])


def broadcast_from_host0(value: str) -> str:
    """Rank 0's ``value`` on every rank of the default process group
    (``broadcast_object_list``): the reference's
    ``trainer.strategy.broadcast`` of the prepared-data cache path.
    Without a group the value comes back unchanged, so callers need no
    branch. Every rank must call it."""
    if not (dist.is_available() and dist.is_initialized()):
        return value
    box = [value]
    # under NCCL the objects travel through the rank's current card
    dist.broadcast_object_list(box, src=0)
    return box[0]
