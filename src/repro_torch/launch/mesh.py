"""Meshes of ranks (twin of ``repro.launch.mesh``).

A :class:`Mesh` names the axes of a grid of ranks, row-major: rank ``r``
sits at the coordinate ``numpy.unravel_index(r, shape)``. Two kinds:

* an axis view (:func:`axes`, :func:`production_axes`): names and sizes
  only, no processes. The sharding rules and the dry-run need nothing
  more, so a 16x16 or 2x16x16 production mesh is priced from one process
  (the reference's tests fake the same with a ``devices.shape``);
* a live mesh (:func:`make_mesh`) over the default process group of
  ``launch.dist``, one rank a device: it also holds this rank's
  coordinate and one process group for every set of its axes, so a
  collective over ``('pod', 'data')`` or over ``'model'`` alone reaches
  exactly the ranks that share the other coordinates.

The reference's ``set_mesh`` and ``shard_map_compat`` are JAX version
shims (an ambient mesh, shard_map's keyword); the port runs eagerly with
explicit collectives, so they have no counterpart here.
"""
from __future__ import annotations

import itertools
import math

import numpy as np


class Mesh:
    """Axis names and sizes; ``coord`` and ``group`` on a live mesh."""

    def __init__(self, shape, axis_names, rank: "int | None" = None,
                 groups: "dict | None" = None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not name its "
                             f"axes {self.axis_names}")
        self.sizes = dict(zip(self.axis_names, self.shape))
        self.size = math.prod(self.shape)
        self.rank = rank
        self._groups = groups

    def __repr__(self) -> str:
        return f"Mesh({self.sizes})"

    @property
    def live(self) -> bool:
        return self._groups is not None

    def coord_of(self, rank: int) -> dict:
        """The coordinate of ``rank``, by axis."""
        return dict(zip(self.axis_names,
                        map(int, np.unravel_index(rank, self.shape))))

    @property
    def coord(self) -> dict:
        """This rank's coordinate, by axis (a live mesh only)."""
        if self.rank is None:
            raise ValueError(f"{self} is an axis view: it has no rank")
        return self.coord_of(self.rank)

    def ordered(self, axes) -> tuple:
        """``axes`` in the mesh's order."""
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group over ``axes`` that holds this rank: its
        members differ only along ``axes`` and come in row-major order of
        their coordinates on them (mesh order, major to minor)."""
        if not self.live:
            raise ValueError(f"{self} is an axis view: it has no groups")
        return self._groups[self.ordered(axes)]


def axes(shape, axis_names) -> Mesh:
    """An axis view: names and sizes, no processes."""
    return Mesh(shape, axis_names)


def _subsets(names: tuple):
    for k in range(1, len(names) + 1):
        yield from itertools.combinations(names, k)


def make_mesh(axis_shapes, axis_names) -> Mesh:
    """A live mesh over the default process group (``launch.dist.init``),
    whose size must be the world size. Every rank creates every subgroup,
    in one order (a rank that skipped one would hang the others until the
    group's timeout)."""
    import torch.distributed as tdist

    from repro_torch.launch import dist
    view = Mesh(axis_shapes, axis_names)
    if not dist.initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "repro_torch.launch.dist.init() first")
    if view.size != dist.world():
        raise ValueError(f"a mesh of {view.size} ranks {view.sizes} over a "
                         f"world of {dist.world()}")
    me = dist.rank()
    groups = {}
    for sub in _subsets(view.axis_names):
        rest = [a for a in view.axis_names if a not in sub]
        for fixed in itertools.product(*(range(view.sizes[a])
                                         for a in rest)):
            at = dict(zip(rest, fixed))
            ranks = []
            for moving in itertools.product(*(range(view.sizes[a])
                                              for a in sub)):
                at.update(zip(sub, moving))
                ranks.append(int(np.ravel_multi_index(
                    [at[a] for a in view.axis_names], view.shape)))
            g = tdist.new_group(ranks)
            if me in ranks:
                groups[sub] = g
    return Mesh(view.shape, view.axis_names, rank=me, groups=groups)


_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def production_axes(*, multi_pod: bool = False) -> Mesh:
    """The production mesh as an axis view (what the dry-run prices):
    16x16 ``('data', 'model')``, or 2x16x16 with ``'pod'``."""
    return axes(*_PRODUCTION[multi_pod])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512), live.

    Axis roles (DESIGN.md §6):
      pod    inter-pod data parallelism (the compressed gradient exchange)
      data   intra-pod data parallelism + FSDP/ZeRO param-and-moment sharding
      model  tensor / expert parallelism (the transformer archs' heads,
             FFN width, experts and vocabulary under the tp layout;
             ``launch.train_lib.MeshStep``)
    """
    return make_mesh(*_PRODUCTION[multi_pod])


def make_host_mesh(max_devices: "int | None" = None) -> Mesh:
    """The whole process group as a 1-D ``'data'`` mesh (tests, examples);
    ``max_devices`` must then be the world size."""
    from repro_torch.launch import dist
    return make_mesh((dist.world() if max_devices is None else max_devices,),
                     ("data",))


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch: ('pod', 'data') when both exist."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
