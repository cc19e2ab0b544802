"""Process meshes over ``torch.distributed`` (counterpart of
``llama32mm_tpu/parallel/mesh.py``).

A mesh lays the ranks of the default process group out as ``(dp, pp, sp,
tp)``, ``tp`` innermost, as the JAX package lays out its devices: the ranks
of one tensor-parallel group are consecutive. Each axis of size > 1 has one
process group per line of the grid; a rank keeps the group of its own line.
Where the JAX package lets the compiler emit its collectives, the port's
forward calls them itself (``Mesh.all_reduce`` / ``Mesh.all_gather`` /
``Mesh.reduce_scatter``, in place or on plain tensors).

The differentiable collectives below are the Megatron pair and its
companions, each a ``torch.autograd.Function`` that returns a new tensor
(an all-reduce in place would overwrite a tensor autograd saved). With one
rank on the axis each is the identity and makes no call; outside autograd
(no gradient wanted) each is the plain collective:

- ``copy_to_tp`` (Megatron's ``f``): identity forward, the gradient summed
  over ``tp`` backward; on the input of every column-parallel linear, whose
  ranks each give a partial gradient of the replicated activation;
- ``reduce_from_tp`` (``g``): the partial products summed forward, identity
  backward; after every row-parallel linear, and the vocab-parallel
  embedding's masked lookups (the same pair: each rank's rows sum, and the
  replicated activation's gradient is whole on every rank);
- ``gather_from_tp``: vocab-parallel logits all-gathered forward, the
  rank's slice of the (whole, replicated) gradient backward;
- ``all_gather`` / ``reduce_scatter`` along any axis (ZeRO's ``dp``): each
  the other's transpose;
- ``ppermute``: a rotation along an axis (rank ``i`` sends to ``i + shift``
  and receives from ``i - shift``, modulo the axis size), whose backward is
  the reverse rotation, as ``jax.lax.ppermute``'s transpose; the ring of
  sequence parallelism and the stage hops of the pipeline.
  ``torch.distributed.nn.functional.all_reduce`` is
  not used: its backward all-reduces the gradient again, which under this
  layout would count a replicated gradient ``tp`` times.

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
                 groups: Optional[dict] = None, device=None, lines: Optional[dict] = None):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.coords = coords
        self.groups = groups or {}
        # the global ranks of this rank's line along each grouped axis, in coordinate order
        self.lines = lines or {}
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

    def reduce_scatter(self, x: torch.Tensor, axis: str = AXIS_DP, dim: int = 0) -> torch.Tensor:
        """``x`` summed over this rank's group along ``axis`` and cut into
        as many equal slices along ``dim``: this rank's slice (a new
        tensor; ``x`` itself is unchanged)."""
        n = self.shape[axis]
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n}")
        parts = [p.contiguous() for p in x.split(x.shape[dim] // n, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self.groups[axis])
        return out

    def ppermute(self, x: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
        """``x`` rotated along ``axis``: this rank sends its ``x`` to the rank
        ``shift`` coordinates on and returns what the rank ``shift``
        coordinates back sent (modulo the axis size; a new tensor). Every
        rank of the line calls it; the sends and receives go in one
        ``batch_isend_irecv``, so the ring cannot deadlock. Gloo takes host
        memory: a CUDA tensor on a gloo group is staged through the host
        (the ranks that share one card); NCCL sends device to device."""
        n = self.shape[axis]
        if n == 1:
            return x
        line, me = self.lines[axis], self.rank(axis)
        send = x.contiguous()
        staged = send.is_cuda and dist.get_backend(self.groups[axis]) == "gloo"
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, line[(me + shift) % n], self.groups[axis]),
               dist.P2POp(dist.irecv, recv, line[(me - shift) % n], self.groups[axis])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(x.device) if staged else recv

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords}, device={self.device})"


def _live(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x`` here."""
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(total, ctx.axis), None, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllGather(torch.autograd.Function):
    """Forward all-gather along ``dim``; backward ``slice`` keeps the rank's
    slice of a replicated gradient, otherwise the gradient is
    reduce-scattered (the transpose of a gather whose result each rank
    differentiates on its own)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, slice_back):
        ctx.mesh, ctx.axis, ctx.dim, ctx.slice_back = mesh, axis, dim, slice_back
        ctx.size = x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.slice_back:
            start = ctx.mesh.rank(ctx.axis) * ctx.size
            out = grad.narrow(ctx.dim, start, ctx.size).contiguous()
        else:
            out = ctx.mesh.reduce_scatter(grad, ctx.axis, ctx.dim)
        return out, None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return mesh.ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.ppermute(grad, ctx.axis, -ctx.shift), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_gather(grad, ctx.axis, ctx.dim), None, None, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_TP) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is; its gradient summed over ``axis``."""
    if mesh.shape[axis] == 1 or not _live(x):
        return x
    return _CopyToTP.apply(x, mesh, axis)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_TP) -> torch.Tensor:
    """Megatron's ``g``: ``x`` summed over ``axis``; the gradient passes
    through. Outside autograd the sum is made in ``x`` itself, as the
    serving forward does."""
    if mesh.shape[axis] == 1:
        return x
    if not _live(x):
        return mesh.all_reduce(x, axis)
    return _ReduceFromTP.apply(x, mesh, axis)


def gather_from_tp(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_TP, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; backward, the rank's
    slice of the gradient (which is whole on every rank)."""
    if mesh.shape[axis] == 1:
        return x
    if not _live(x):
        return mesh.all_gather(x, axis, dim)
    return _AllGather.apply(x, mesh, axis, dim % x.dim(), True)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_DP, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; backward, the gradient
    reduce-scattered over ``axis``."""
    if mesh.shape[axis] == 1:
        return x
    if not _live(x):
        return mesh.all_gather(x, axis, dim)
    return _AllGather.apply(x, mesh, axis, dim % x.dim(), False)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_DP, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axis``, this rank's slice along ``dim``;
    backward, the gradient all-gathered."""
    if mesh.shape[axis] == 1:
        return x
    if not _live(x):
        return mesh.reduce_scatter(x, axis, dim)
    return _ReduceScatter.apply(x, mesh, axis, dim % x.dim())


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """``Mesh.ppermute`` under autograd: the gradient rotates back (``-shift``).
    With one rank on the axis, ``x`` itself and no call."""
    if mesh.shape[axis] == 1:
        return x
    if not _live(x):
        return mesh.ppermute(x, axis, shift)
    return _PPermute.apply(x, mesh, axis, shift)


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
    groups, own_lines = {}, {}
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
                groups[axis], own_lines[axis] = g, line
    return Mesh(shape, coords, groups, device, own_lines)


def single_device_mesh(device="cuda") -> Mesh:
    """The one-rank mesh: no process group, no collective."""
    return Mesh({}, dict.fromkeys(AXES, 0), {}, device)
