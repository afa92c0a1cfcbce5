"""The device mesh over the five logical parallelism axes; port of
``githubrepostorag_tpu/parallel/mesh.py``.

JAX lays a ``jax.sharding.Mesh`` over its device list and lets XLA insert
the collectives.  Here every rank of a ``torch.distributed`` world is one
device: ``make_mesh`` places this rank at its coordinates in the same
row-major ``(dp, pp, tp, sp, ep)`` grid JAX reshapes its devices into, and
holds one process group per axis (the ranks that differ from this one
along that axis only), over which the port calls its collectives by hand
(``parallel/collectives.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist

from githubrepostorag_tpu_torch.parallel import distributed

# Order matters: earlier axes vary slowest over the device list, as in JAX.
AXIS_NAMES = ("dp", "pp", "tp", "sp", "ep")


@dataclass(frozen=True)
class MeshPlan:
    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp * self.sp * self.ep

    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp, "sp": self.sp, "ep": self.ep}


@dataclass
class Mesh:
    """One rank's place in a ``MeshPlan``: its coordinates (all 0 unless
    given) and its process group on each axis (none outside a
    ``torch.distributed`` world).  ``Mesh(plan, coords)`` alone is a
    layout: enough for the sharding rules and for cutting a rank's slices."""

    plan: MeshPlan
    coords: dict[str, int] = field(default_factory=dict)
    groups: dict[str, dist.ProcessGroup] = field(default_factory=dict)

    axis_names = AXIS_NAMES

    def __post_init__(self):
        self.coords = {name: self.coords.get(name, 0) for name in AXIS_NAMES}
        for name, n in self.plan.shape().items():
            if not 0 <= self.coords[name] < n:
                raise ValueError(f"coordinate {name}={self.coords[name]} outside the plan's "
                                 f"{name}={n}")

    @property
    def shape(self) -> dict[str, int]:
        return self.plan.shape()

    @property
    def index(self) -> int:
        """This rank's position in the row-major device grid."""
        return int(np.ravel_multi_index([self.coords[a] for a in AXIS_NAMES],
                                        [self.shape[a] for a in AXIS_NAMES]))

    def group(self, axis: str) -> dist.ProcessGroup | None:
        return self.groups.get(axis)

    def barrier(self) -> None:
        """Wait for every rank of the mesh: a barrier on each axis in turn
        reaches the whole grid (each rank waits for its axis peers, which
        waited for theirs on the earlier axes)."""
        for name in AXIS_NAMES:
            if name in self.groups:
                dist.barrier(group=self.groups[name])


def make_mesh(plan: MeshPlan | None = None, devices=None, **axes: int) -> Mesh | None:
    """This rank's ``Mesh`` for ``plan`` (or keyword axis sizes).

    ``devices`` are the global ranks the grid spans, in order (default:
    every rank of the world, or the one process when ``torch.distributed``
    is not initialised); the grid takes the first ``plan.n_devices`` of
    them.  Inside a world every rank must call ``make_mesh`` with the same
    arguments, in the same order as its other ``make_mesh`` calls: process
    groups are created collectively.  A rank outside the grid gets None.

    With ``torch.distributed`` running, every axis gets its group, an axis
    of size 1 too, so a one-rank world runs every collective of a step
    (on the card: over NCCL) the way a larger world does.  Without it the
    plan must be one device, and there are no groups."""
    if plan is None:
        plan = MeshPlan(**axes)
    elif axes:
        raise TypeError("pass either a MeshPlan or keyword axis sizes, not both")
    live = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = range(dist.get_world_size() if live else 1)
    devices = list(devices)
    if plan.n_devices > len(devices):
        raise ValueError(
            f"mesh plan {plan.shape()} needs {plan.n_devices} devices, "
            f"only {len(devices)} available"
        )
    devices = devices[: plan.n_devices]
    sizes = [plan.shape()[a] for a in AXIS_NAMES]
    grid = np.asarray(devices).reshape(sizes)
    me = dist.get_rank() if live else devices[0]
    groups = {}
    if live:
        timeout = distributed.group_timeout()
        for axis, name in enumerate(AXIS_NAMES):
            # each line of the grid along this axis is one group
            lines = np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis])
            group, _ = dist.new_subgroups_by_enumeration(
                [[int(r) for r in line] for line in lines], timeout=timeout)
            if group is not None:
                groups[name] = group
    if me not in devices:
        return None
    pos = np.unravel_index(devices.index(me), sizes)
    return Mesh(plan, {name: int(i) for name, i in zip(AXIS_NAMES, pos)}, groups)


def plan_for_devices(
    n: int,
    *,
    num_heads: int | None = None,
    num_kv_heads: int | None = None,
    role: str = "serve",
) -> MeshPlan:
    """Factor ``n`` devices into a sensible default plan.

    serve: all-TP (latency — every chip works on every token), capped at the
    largest power-of-two divisor of ``num_heads`` (and kv heads if given, so
    the attention shard_map specs divide cleanly); leftover devices become dp.
    train: balance dp × tp × sp so batch, heads, and sequence all shard.
    ingest: all-DP (throughput — independent batch rows).
    """
    if n < 1:
        raise ValueError("need at least one device")

    def tp_for(n: int) -> int:
        # largest power of two that divides the device count AND every given
        # head count — never strands devices, never splits a head
        tp = _pow2_floor(n)
        heads = [h for h in (num_heads, num_kv_heads) if h is not None]
        while tp > 1 and not (n % tp == 0 and all(h % tp == 0 for h in heads)):
            tp //= 2
        return tp

    if role == "ingest":
        return MeshPlan(dp=n)
    if role == "serve":
        tp = tp_for(n)
        return MeshPlan(dp=n // tp, tp=tp)
    if role == "train":
        # peel off tp first (bounded by heads), then split the rest between
        # dp and sp as evenly as powers of two allow
        tp = tp_for(n)
        rest = n // tp
        sp = _pow2_floor(int(rest**0.5))
        while rest % sp != 0:
            sp //= 2
        return MeshPlan(dp=rest // sp, tp=tp, sp=sp)
    raise ValueError(f"unknown role {role!r}")


def plan_from_string(spec: str) -> MeshPlan:
    """Parse the MESH_SHAPE env format: ``"dp:2,tp:4"`` (axes omitted are
    size 1).  The operator's explicit override of ``plan_for_devices``."""
    axes: dict[str, int] = {}
    for part in spec.replace(" ", "").split(","):
        if not part:
            continue
        name, _, size = part.partition(":")
        if name not in AXIS_NAMES or not size.isdigit() or int(size) < 1:
            raise ValueError(
                f"bad MESH_SHAPE entry {part!r}: want axis:size with axis in {AXIS_NAMES}"
            )
        if name in axes:  # "tp:4,tp:2" is a typo, not a request for tp=2
            raise ValueError(f"bad MESH_SHAPE: axis {name!r} given twice")
        axes[name] = int(size)
    return MeshPlan(**axes)


def _pow2_floor(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p
