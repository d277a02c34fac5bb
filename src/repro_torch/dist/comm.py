"""Process groups of a DeviceMesh, the collectives the port uses, and the
autograd functions that carry tensor parallelism through a model.

``MeshComm(mesh)`` builds one process group for every set of mesh dimensions
(``("model",)``, ``("data",)``, ``("pod", "data")``, ...) on every rank in
the same order, and keeps the group this rank belongs to; a set of size 1
has no group, and each collective on it is the identity. A group's ranks are
ordered by their mesh coordinates over the set, major first, so a gather
concatenates shards in the order the placements (``sharding.placements_for``)
give them.

The collectives choose their implementation by the backend's name
(``native``), never by catching an error: NCCL, and gloo on CPU tensors, take
``all_gather_into_tensor`` and ``reduce_scatter_tensor``; gloo on CUDA tensors
(ranks that share one card) keeps to all-reduce and all-gather: a gather is
the list form of ``all_gather``, a reduce-scatter all-reduces the whole tensor
and keeps this rank's part, and each of them moves a tensor in pieces of at
most ``GLOO_CUDA_PIECE`` bytes (gloo stages CUDA tensors in host buffers).

The autograd functions follow Megatron-LM's: ``copy_to`` is the identity
whose backward all-reduces (the entry of a region whose consumers each see
part of the gradient), ``reduce_from`` all-reduces forward and passes the
gradient through (the exit of a row-parallel product; every rank then holds
the same loss), ``all_reduce_sum`` all-reduces both ways (a sum over the
batch ranks whose losses the step averages), ``gather`` all-gathers forward
and reduce-scatters back, or only slices back (``grads="same"``) where every
rank's gradient of the gathered tensor is the same. ``track_gathers()``
counts the bytes of ``gather``'s outputs alive at once (FSDP's gathered
weights), for the tests and the card's smoke run.

``merge_attention`` is the flash-decoding merge one level above the kernel's:
the ranks that hold disjoint slices of a cache's slots (``kv_seq``) each
compute a partial attention and its log-sum-exp (``flash_decode(...,
return_lse=True)``), gather them all in one list all-gather, and combine them
with ``combine_partials``, the same arithmetic on every rank, so the ranks'
results are bit-equal.

``current()`` is the model code's view of the installed axis rules
(``models.common.axis_rules``): None without rules or without a DeviceMesh,
else a ``Parallel`` that says which logical axes are local shards over
``model`` and over which mesh axes the batch rows are split.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import weakref
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

PG_TIMEOUT = timedelta(seconds=120)  # a rank that never answers fails its peers' collective
GLOO_CUDA_PIECE = 256 * 2**20

_COMMS: dict = {}  # id(mesh) -> (mesh, MeshComm)


class MeshComm:
    """The process groups of one ``DeviceMesh`` (named dimensions)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, mesh.shape))
        ranks = mesh.mesh
        coord = mesh.get_coordinate()
        if coord is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh {self.sizes}")
        self.coord = dict(zip(self.names, coord))
        self.backend = str(dist.get_backend())
        self._groups: dict = {}
        for k in range(1, len(self.names) + 1):
            for dims in itertools.combinations(range(len(self.names)), k):
                key = tuple(self.names[d] for d in dims)
                if self.size(key) == 1:
                    continue
                rest = [d for d in range(len(self.names)) if d not in dims]
                for fixed in itertools.product(*(range(ranks.shape[d]) for d in rest)):
                    idx = [slice(None)] * len(self.names)
                    for d, c in zip(rest, fixed):
                        idx[d] = c
                    members = ranks[tuple(idx)].reshape(-1).tolist()
                    g = dist.new_group(sorted(members), timeout=PG_TIMEOUT)
                    if all(self.coord[self.names[d]] == c for d, c in zip(rest, fixed)):
                        self._groups[key] = g

    def _key(self, dims) -> tuple:
        dims = (dims,) if isinstance(dims, str) else tuple(dims)
        return tuple(n for n in self.names if n in dims)

    def size(self, dims) -> int:
        return math.prod(self.sizes[n] for n in self._key(dims))

    def index(self, dims) -> int:
        """This rank's index in the group of ``dims`` (row-major over them)."""
        i = 0
        for n in self._key(dims):
            i = i * self.sizes[n] + self.coord[n]
        return i

    def group(self, dims):
        """The process group of ``dims`` holding this rank, None at size 1."""
        return self._groups.get(self._key(dims))

    # -- collectives -------------------------------------------------------
    def native(self, t: torch.Tensor) -> bool:
        """Whether the backend takes gather and reduce-scatter itself: NCCL,
        and gloo on CPU tensors; gloo on CUDA tensors gets them through
        all_reduce."""
        return self.backend == "nccl" or not t.is_cuda

    def _pieces(self, t: torch.Tensor) -> list:
        """``t`` (contiguous) as flat views of at most GLOO_CUDA_PIECE bytes
        for gloo on CUDA tensors, else whole."""
        if self.native(t):
            return [t]
        flat = t.view(-1)
        n = max(1, GLOO_CUDA_PIECE // t.element_size())
        return [flat[i : i + n] for i in range(0, flat.numel(), n)]

    def all_reduce(self, t: torch.Tensor, dims, op: str = "sum") -> torch.Tensor:
        """``t`` (contiguous) summed (or its max, ``op="max"``) over the
        group, in place."""
        g = self.group(dims)
        if g is not None:
            for piece in self._pieces(t):
                dist.all_reduce(piece, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=g)
        return t

    def all_gather(self, t: torch.Tensor, dim: int, dims) -> torch.Tensor:
        """The group's shards of ``t`` concatenated along ``dim``
        (contiguous, as the kernels take their inputs)."""
        g, n = self.group(dims), self.size(dims)
        if g is None:
            return t
        tm = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * tm.shape[0],) + tuple(tm.shape[1:]), dtype=t.dtype, device=t.device)
        if self.native(t):
            dist.all_gather_into_tensor(out, tm, group=g)
        else:
            parts = out.view(n, -1)
            off = 0
            for piece in self._pieces(tm):
                dist.all_gather(list(parts[:, off : off + piece.numel()].unbind(0)), piece, group=g)
                off += piece.numel()
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, dim: int, dims) -> torch.Tensor:
        """``t`` summed over the group, this rank's 1/n part along ``dim``."""
        g, n = self.group(dims), self.size(dims)
        if g is None:
            return t
        tm = t.movedim(dim, 0).contiguous()
        part = tm.shape[0] // n
        if self.native(t):
            out = torch.empty((part,) + tuple(tm.shape[1:]), dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, tm, group=g)
        else:
            if tm.data_ptr() == t.data_ptr():  # reduced in place: never the caller's tensor
                tm = tm.clone()
            self.all_reduce(tm, dims)
            i = self.index(dims)
            out = tm[i * part : (i + 1) * part]
        return out.movedim(0, dim).contiguous()

    def shard(self, t: torch.Tensor, dim: int, dims) -> torch.Tensor:
        """This rank's 1/n part of ``t`` along ``dim`` (no communication)."""
        n = self.size(dims)
        if n == 1:
            return t
        part = t.shape[dim] // n
        return t.narrow(dim, self.index(dims) * part, part)


def comm_for(mesh) -> MeshComm:
    """The ``MeshComm`` of ``mesh``, built once (every rank must make the
    first call at the same point: it creates process groups)."""
    hit = _COMMS.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = (mesh, MeshComm(mesh))
        _COMMS[id(mesh)] = hit
    return hit[1]


def combine_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The merge of n partial attentions over disjoint slices of the slots:
    outs (n, B, L, H, Dh) and lses (n, B, H) -> sum_r w_r out_r / sum_r w_r
    with w_r = exp(lse_r - max_r lse_r), in f32 (f64 for f64 inputs). A slice
    with no live slot (lse NEG_INF) weighs 0 beside a live one, as
    ``flash_decode``'s own block merge weighs an empty chunk."""
    acc = torch.promote_types(outs.dtype, torch.float32)
    lses = lses.to(acc)
    w = torch.exp(lses - lses.amax(0))[:, :, None, :, None]  # (n, B, 1, H, 1)
    return (w * outs.to(acc)).sum(0) / w.sum(0)


def merge_attention(out: torch.Tensor, lse: torch.Tensor, comm: MeshComm, dims) -> torch.Tensor:
    """This rank's partial attention out (B, L, H, Dh) and its log-sum-exp
    lse (B, H), merged with the partials of the group of ``dims``: one
    all-gather of both (f32, packed), then ``combine_partials``."""
    n = comm.size(dims)
    if n == 1:
        return out.float()
    packed = torch.cat([out.float().reshape(-1), lse.float().reshape(-1)])
    every = comm.all_gather(packed[None], 0, dims)  # (n, packed)
    outs = every[:, : out.numel()].reshape((n,) + tuple(out.shape))
    return combine_partials(outs, every[:, out.numel():].reshape((n,) + tuple(lse.shape)))


# ---------------------------------------------------------------------------
# Autograd functions
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims):
        ctx.comm, ctx.dims = comm, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone(), ctx.dims), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims):
        return comm.all_reduce(x.contiguous().clone(), dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims):
        ctx.comm, ctx.dims = comm, dims
        return comm.all_reduce(x.contiguous().clone(), dims)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone(), ctx.dims), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, dims, same):
        ctx.comm, ctx.dim, ctx.dims, ctx.same = comm, dim, dims, same
        return comm.all_gather(x, dim, dims)

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        out = c.shard(g, ctx.dim, ctx.dims) if ctx.same else c.reduce_scatter(g, ctx.dim, ctx.dims)
        return out.contiguous(), None, None, None, None


def copy_to(x: torch.Tensor, comm: MeshComm, dims) -> torch.Tensor:
    return x if comm.size(dims) == 1 else _CopyTo.apply(x, comm, dims)


def reduce_from(x: torch.Tensor, comm: MeshComm, dims) -> torch.Tensor:
    return x if comm.size(dims) == 1 else _ReduceFrom.apply(x, comm, dims)


def all_reduce_sum(x: torch.Tensor, comm: MeshComm, dims) -> torch.Tensor:
    return x if comm.size(dims) == 1 else _AllReduceSum.apply(x, comm, dims)


def gather(x: torch.Tensor, comm: MeshComm, dim: int, dims, grads: str = "sum") -> torch.Tensor:
    """All-gather along ``dim``; the backward reduce-scatters (``grads="sum"``:
    each rank holds its own part of the gradient) or slices (``"same"``:
    every rank holds the whole, equal gradient)."""
    if comm.size(dims) == 1:
        return x
    out = _Gather.apply(x, comm, dim, dims, grads == "same")
    for track in _TRACKS:
        if track.axes is None or set(comm._key(dims)) & set(track.axes):
            track.add(out)
    return out


_TRACKS: list = []  # the open track_gathers() counts


class GatherTrack:
    """The outputs of ``gather`` made while it is open (over any of the mesh
    axes ``axes``; every one where None): their number (``count``) and the
    bytes of those alive at once (``live``; ``peak``, the most), each freed
    when its storage goes (a weakref finalizer), on whatever thread that
    happens."""

    def __init__(self, axes=None):
        self.axes = axes
        self.count = self.live = self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        nb = st.nbytes()
        self.count += 1
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, nb)

    def _free(self, nb: int) -> None:
        self.live -= nb


@contextlib.contextmanager
def track_gathers(axes=None):
    """A ``GatherTrack`` of the gathers over ``axes`` made inside (a
    recompute's too): ``("pod", "data")`` for FSDP's."""
    track = GatherTrack(axes)
    _TRACKS.append(track)
    try:
        yield track
    finally:
        _TRACKS.remove(track)


# ---------------------------------------------------------------------------
# The model code's view of the installed rules
# ---------------------------------------------------------------------------

TP_AXES = ("vocab", "heads", "kv_heads", "mlp", "experts", "inner")


@dataclasses.dataclass(frozen=True)
class Parallel:
    """What the model code needs of the rules on a DeviceMesh: the logical
    axes held as shards over ``model`` (``local``), tp and this rank's index
    on it, and the mesh axes the batch rows are split over (``batch``, with
    dp and this rank's index there)."""

    comm: MeshComm
    local: frozenset
    batch: tuple

    @property
    def tp(self) -> int:
        return self.comm.size("model") if "model" in self.comm.sizes else 1

    @property
    def tp_rank(self) -> int:
        return self.comm.index("model") if "model" in self.comm.sizes else 0

    @property
    def dp(self) -> int:
        return self.comm.size(self.batch)

    @property
    def dp_rank(self) -> int:
        return self.comm.index(self.batch)

    def sharded(self, name: str) -> bool:
        return name in self.local

    # tensor parallelism over "model" (identity at tp 1)
    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.comm, ("model",)) if self.tp > 1 else x

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.comm, ("model",)) if self.tp > 1 else x

    def model_slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's 1/tp part of ``x`` along ``dim``."""
        return self.comm.shard(x, dim, ("model",)) if self.tp > 1 else x

    # sums over the batch ranks
    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the batch ranks (adjoint: the same sum)."""
        return all_reduce_sum(x, self.comm, self.batch)

    def batch_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The batch ranks' ``x`` stacked on a new leading axis, in their
        order (no gradient)."""
        return self.comm.all_gather(x[None], 0, self.batch)


def parallel_of(rules: dict, mesh) -> Optional[Parallel]:
    """The ``Parallel`` view of ``rules`` on ``mesh``; None unless ``mesh``
    is a DeviceMesh."""
    if getattr(mesh, "mesh_dim_names", None) is None or not hasattr(mesh, "get_coordinate"):
        return None
    comm = comm_for(mesh)
    tp = comm.sizes.get("model", 1)
    local = frozenset(a for a in TP_AXES if tp > 1 and rules.get(a) == "model")
    b = rules.get("batch")
    batch = tuple(a for a in ((b,) if isinstance(b, str) else tuple(b or ())) if comm.sizes.get(a, 1) > 1)
    return Parallel(comm, local, batch)


def current() -> Optional[Parallel]:
    """The installed rules' ``Parallel`` view, or None (no rules, no mesh)."""
    from repro_torch.models.common import get_axis_rules

    ctx = get_axis_rules()
    if ctx is None:
        return None
    return parallel_of(ctx[0], ctx[1])
