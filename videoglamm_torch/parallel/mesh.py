"""The (data, model) mesh of ranks (PyTorch port of
videoglamm_tpu/parallel/mesh.py).

JAX lays its devices out as one `jax.sharding.Mesh` with two logical axes
and lets GSPMD insert the collectives. Here a `Mesh` is a grid of
`torch.distributed` ranks with the same two axes:

- ``data``  : the batch is split over it, and the AdamW moments are split
              over it too (ZeRO-2);
- ``model`` : tensor parallelism of Phi-3's decoder layers, and the
              sharded storage of the other weights named by
              `partitioning.param_partition_spec`.

Rank r of the mesh's rank list sits at (r // model, r % model), the order
in which `np.reshape(devices, (data, model))` lays the devices out. The
ranks of one data row form this rank's model group, those of one model
column its data group. An axis of size 1 has no group: its collectives are
identities and are not issued.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# one process group per rank set: torch names a group made with
# use_local_synchronization after its ranks, so a second group over the
# same ranks cannot be made
_GROUPS: Dict[Tuple[int, ...], object] = {}


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group (None for an
    axis of size 1), its size and this rank's index along it."""
    group: Optional[object]
    size: int
    index: int


def _group(ranks: Tuple[int, ...]):
    if len(ranks) == 1:
        return None
    if ranks not in _GROUPS:
        # only the group's members take part in making it, so meshes over
        # disjoint rank sets may be made side by side
        _GROUPS[ranks] = dist.new_group(list(ranks),
                                        use_local_synchronization=True)
    return _GROUPS[ranks]


class Mesh:
    """A (data, model) grid of ranks with this rank's coordinates, its two
    axis groups and the group of the whole mesh. `shape` maps each axis
    name to its size, as a JAX mesh's does."""

    def __init__(self, data: int, model: int, ranks: Sequence[int], rank: int):
        self.ranks = tuple(ranks)
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.rank = rank
        pos = self.ranks.index(rank)
        d, m = divmod(pos, model)
        row = self.ranks[d * model:(d + 1) * model]
        col = self.ranks[m::model]
        self.axes = {MODEL_AXIS: Axis(_group(row), model, m),
                     DATA_AXIS: Axis(_group(col), data, d)}
        self.group = _group(self.ranks)     # every rank of the mesh

    @property
    def is_first(self) -> bool:
        """This rank is the mesh's first (the one that writes files)."""
        return self.rank == self.ranks[0]

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def __repr__(self):
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, rank={self.rank} at "
                f"({self.axes[DATA_AXIS].index}, {self.axes[MODEL_AXIS].index}))")


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(data: int = -1, model: int = 1,
                ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (data, model) mesh over `ranks` (every rank of the world by
    default; this rank must be one of them). data=-1 takes what `model`
    leaves. With no process group the world is rank 0 alone. Shapes that
    do not fit raise ValueError with the JAX function's messages."""
    world, rank = _world()
    ranks = list(range(world)) if ranks is None else list(ranks)
    n = len(ranks)
    if data <= 0:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not in the mesh's ranks {ranks}")
    return Mesh(data, model, ranks, rank)


def local_mesh() -> Mesh:
    """Pure data parallelism over every rank of the world."""
    return create_mesh(data=_world()[0], model=1)
