"""Device meshes over the ranks of a torch.distributed world.

Mirror of ``paddle_tpu/parallel/mesh.py``. The JAX package's mesh is a
`jax.sharding.Mesh` over devices, and GSPMD inserts the collectives along
its named axes. Here each rank is one process with one device, and a
`Mesh` lays the world's ranks out on named axes ('dp' data, 'mp' model,
'sp' sequence): rank r sits at r's row-major coordinates, and every slice
along an axis (the ranks that differ only in that axis's coordinate) has
a process group of its own, over which ``parallel/spmd.py`` issues the
axis's collectives.

fluid-planner: `auto_mesh(program, n_devices)` derives the dp x mp x sp
split from the program's cost model instead of a hand-picked tuple
(``analysis/planner.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .. import distributed as _dist


class Mesh:
    """Named axes over ranks 0 .. n-1 of the world. `shape` maps each
    axis name to its size (in axis order), `devices` is the rank array
    (its `.size` the mesh's rank count, as a JAX mesh's device array),
    `coords` this rank's coordinate on each axis."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        import torch.distributed as dist
        self.axis_names = tuple(axis_names)
        sizes = [int(s) for s in axis_sizes]
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh axis sizes {sizes} and names "
                             f"{self.axis_names} differ in length")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        n = int(np.prod(sizes)) if sizes else 1
        self.devices = np.arange(n).reshape(sizes)
        self.rank = _dist.get_rank()
        self.member = self.rank < n
        self.coords: Dict[str, int] = {}
        if self.member:
            where = np.argwhere(self.devices == self.rank)[0]
            self.coords = {a: int(c) for a, c in zip(self.axis_names, where)}
        # one group per slice of every axis over more than one rank; every
        # rank of the world creates every group, in the same order
        # (torch.distributed.new_group's contract)
        self._groups = {}
        self._peers = {}
        for ax, a in enumerate(self.axis_names):
            if self.shape[a] == 1:
                continue
            moved = np.moveaxis(self.devices, ax, -1).reshape(-1,
                                                              self.shape[a])
            for ranks in moved:
                ranks = [int(r) for r in ranks]
                group = dist.new_group(ranks) if dist.is_initialized() \
                    else None
                if self.rank in ranks:
                    self._groups[a] = group
                    self._peers[a] = ranks

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (0 for an axis it lacks)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's slice along `axis`."""
        return self._groups[axis]

    def peers(self, axis: str):
        """The global ranks of this rank's slice along `axis`, in axis
        order."""
        return self._peers.get(axis, [self.rank])

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of `axis_sizes` over the first ranks of the world; `devices`
    (a rank count or a sequence of ranks) caps what it may use."""
    have = _dist.get_world_size()
    if devices is not None:
        have = min(have, devices if isinstance(devices, int)
                   else len(list(devices)))
    n = int(np.prod(axis_sizes))
    if n > have:
        raise ValueError(f"mesh needs {n} devices, have {have}")
    return Mesh(axis_sizes, axis_names)


def get_default_mesh(num_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over the world (ParallelExecutor default)."""
    n = _dist.get_world_size()
    if num_devices is not None:
        n = min(n, int(num_devices))
    return make_mesh([n], ["dp"])


def auto_mesh(program, n_devices: Optional[int] = None,
              feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
              devices=None, hw=None, default_batch: int = 8,
              return_report: bool = False):
    """Cost-model-driven mesh selection (fluid-planner): search the
    dp x mp x sp factorizations of `n_devices` for `program` and build
    the Mesh of the fastest-predicted feasible candidate. `hw` is an
    `analysis.planner.HardwareSpec` (default: `detect_hardware()`, the
    H100's profile on a card, the CPU rehearsal profile on the host).
    `return_report=True` also returns the ranked `PlanReport`. Raises
    ValueError when no candidate is feasible, naming each rejection."""
    from ..analysis import planner as _planner

    n = int(n_devices) if n_devices is not None else _dist.get_world_size()
    if feed_shapes is None:
        # only the BATCH dim may be defaulted: a non-batch -1 has no sane
        # default, and planning sp at a made-up extent would mis-rank
        feed_shapes = {}
        for v in program.global_block().vars.values():
            if not getattr(v, "is_data", False) or v.shape == ():
                continue
            shape = [int(d) for d in v.shape]
            if any(d == -1 for d in shape[1:]):
                raise ValueError(
                    f"auto_mesh: data var {v.name!r} has a dynamic "
                    f"non-batch dim {tuple(shape)} — pass feed_shapes= "
                    f"with the concrete extents the workload will run")
            if shape and shape[0] == -1:
                shape[0] = int(default_batch)
            feed_shapes[v.name] = tuple(shape)
    report = _planner.plan_meshes(program, feed_shapes, n, hw=hw)
    best = report.best
    if best is None:
        reasons = "; ".join(f"{c.label()}: {c.reason}"
                            for c in report.candidates)
        raise ValueError(
            f"auto_mesh: no feasible dp*mp*sp split of {n} device(s) "
            f"for this program — {reasons}")
    mesh = make_mesh([best.dp, best.mp, best.sp], ["dp", "mp", "sp"],
                     devices)
    return (mesh, report) if return_report else mesh


class _Spec:
    """A placement spec on a mesh: per dim, the axis it is split over
    (None: whole), the JAX package's `NamedSharding(mesh,
    PartitionSpec(...))`."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"PartitionSpec{self.spec}"


def replicated(mesh: Mesh) -> _Spec:
    return _Spec(mesh, ())


def batch_sharded(mesh: Mesh, axis: str = "dp") -> _Spec:
    return _Spec(mesh, (axis,))
