"""Process meshes over ``torch.distributed`` (counterpart of
``llama32mm_tpu/parallel/mesh.py``).

A mesh lays the ranks of the default process group out as ``(dp, pp, sp,
tp)``, ``tp`` innermost, as the JAX package lays out its devices: the ranks
of one tensor-parallel group are consecutive. Each axis of size > 1 has one
process group per line of the grid; a rank keeps the group of its own line.
Where the JAX package lets the compiler emit its collectives, the port's
forward calls them itself (``Mesh.all_reduce`` / ``Mesh.all_gather``).

Which backend and device a rank uses (``init_distributed``):

- every rank has its own GPU: NCCL, rank ``r`` on ``cuda:r``;
- the CPU (the tests), only when the caller asks for it: gloo;
- more ranks than GPUs: only when the caller passes ``share_device=True``,
  every rank on one card over gloo (NCCL refuses two ranks on one device),
  and rank 0 prints a line saying so. This is the counterpart of the JAX
  package's virtual-device mesh; its times are not multi-GPU times.

No rule picks the CPU or a shared card by itself: a ``cuda`` request with too
few GPUs and no ``share_device`` raises.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_TP = "tp"
AXES = (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP)

# the device ``init_distributed`` chose for this process
_RANK_DEVICE: Optional[torch.device] = None


def init_distributed(rank: int, world_size: int, init_method: str, device: str = "cuda",
                     share_device: bool = False, timeout_s: float = 600.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` (the
    address, e.g. ``tcp://localhost:29500``, in ``init_method``) with the
    backend the device rules above give; returns this rank's device, which
    ``create_mesh`` then uses."""
    global _RANK_DEVICE
    if device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    elif device == "cuda":
        n = torch.cuda.device_count()
        if n >= world_size:
            backend, dev = "nccl", torch.device("cuda", rank)
        elif share_device and n >= 1:
            backend, dev = "gloo", torch.device("cuda", 0)
            if rank == 0:
                print(f"init_distributed: {world_size} ranks share cuda:0 "
                      f"({torch.cuda.get_device_name(0)}) over gloo; NCCL refuses two ranks on "
                      f"one device, and these are not multi-GPU times", flush=True)
        else:
            raise RuntimeError(
                f"{world_size} ranks need {world_size} GPUs, found {n}; pass share_device=True "
                "to run them on one card over gloo, or device='cpu'")
        torch.cuda.set_device(dev)
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE = dev
    return dev


class Mesh:
    """``shape`` ({axis: size} over ``AXES``); for a rank in the mesh, its
    coordinate and process group along each axis and its device. A mesh
    built with ``Mesh(shape)`` alone is a layout (no ranks, no groups):
    enough for ``param_shardings`` to check how a configuration divides."""

    def __init__(self, shape: Dict[str, int], coords: Optional[Dict[str, int]] = None,
                 groups: Optional[dict] = None, device=None):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.coords = coords
        self.groups = groups or {}
        self.device = None if device is None else torch.device(device)

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return self.coords is not None

    def rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 for a layout)."""
        return 0 if self.coords is None else self.coords[axis]

    def all_reduce(self, x: torch.Tensor, axis: str = AXIS_TP,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced in place over this rank's group along ``axis`` (no
        call when the axis has size 1); returns ``x``."""
        if self.shape[axis] > 1:
            dist.all_reduce(x, op=op, group=self.groups[axis])
        return x

    def all_gather(self, x: torch.Tensor, axis: str = AXIS_TP, dim: int = -1) -> torch.Tensor:
        """The ``x`` of every rank of this rank's group along ``axis``,
        concatenated along ``dim`` in coordinate order."""
        n = self.shape[axis]
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.groups[axis])
        return torch.cat(parts, dim=dim)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords}, device={self.device})"


def _grid(shape: Dict[str, int]):
    """Global rank of each coordinate tuple, ``tp`` fastest."""
    grid, rank = {}, 0
    for d in range(shape[AXIS_DP]):
        for p in range(shape[AXIS_PP]):
            for s in range(shape[AXIS_SP]):
                for t in range(shape[AXIS_TP]):
                    grid[(d, p, s, t)] = rank
                    rank += 1
    return grid


def create_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1, device=None) -> Mesh:
    """A ``(dp, pp, sp, tp)`` mesh over the first ``dp·pp·sp·tp`` ranks of the
    default process group (every rank of the group must call this, in the
    same order as its other ``create_mesh`` calls: the groups are created
    collectively). Without a process group the world is this one process.
    ``device``: this rank's device; by default the one ``init_distributed``
    chose, or ``cuda`` for a single process. A rank past the mesh gets a mesh
    it is not a member of."""
    shape = {AXIS_DP: dp, AXIS_PP: pp, AXIS_SP: sp, AXIS_TP: tp}
    n = dp * pp * sp * tp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if min(shape.values()) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")
    if n > world:
        raise ValueError(f"mesh {dp}x{pp}x{sp}x{tp} needs {n} ranks, have {world}")
    me = dist.get_rank() if dist.is_initialized() else 0
    if device is None:
        device = _RANK_DEVICE
    if device is None:
        if world > 1:
            raise ValueError("create_mesh: pass device= (this process did not join through "
                             "init_distributed, so its device is not known)")
        device = "cuda"
    grid = _grid(shape)
    coords = None
    for c, r in grid.items():
        if r == me:
            coords = dict(zip(AXES, c))
    groups = {}
    for i, axis in enumerate(AXES):
        if shape[axis] == 1:
            continue
        # one group per line along `axis`, created in grid order on every rank
        lines = {}
        for c, r in grid.items():
            lines.setdefault(c[:i] + c[i + 1:], []).append(r)
        for line in lines.values():
            g = dist.new_group(line)
            if me in line:
                groups[axis] = g
    return Mesh(shape, coords, groups, device)


def single_device_mesh(device="cuda") -> Mesh:
    """The one-rank mesh: no process group, no collective."""
    return Mesh({}, dict.fromkeys(AXES, 0), {}, device)
