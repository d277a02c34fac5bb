"""What one rank's run of a step computes, moves and holds, counted op by op.

Port of ``repro.roofline.hlo_costs``, which walks the optimized HLO of a
compiled step. The port's step is eager PyTorch, so its program is the
sequence of ATen and c10d ops it dispatches: ``OpCounter`` is a
``TorchDispatchMode`` that sees each of them once, as this rank issues it,
on meta tensors on a fake ``DeviceMesh`` (``launch/dryrun.py``) or on any
other tensors. Eager torch runs every layer, so no trip count is needed,
except where a ghost run does not walk a loop: ops under
``models.common.cost_repeat(n)`` are charged n times (the plain Mamba scan on
meta tensors, ``kernels/ref.py::_walk``), as ``hlo_costs`` charges a while
body times its trip count.

Counted (the reference's rules, on ATen ops):
  - dot FLOPs (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``):
    2 x elems(result) x the contraction extent (the bias of ``addmm`` and
    ``baddbmm`` one more FLOP an element), reported as ``dot_flops``;
  - elementwise FLOPs (ops tagged ``pointwise``, copies excluded): one an
    element of the result, four for the transcendental ones; reductions
    (ops tagged ``reduction``): elems(operand); softmax and log-softmax
    eight an element, their backward four; reported as ``other_flops``;
  - traffic: the bytes each op reads and writes, every input read once (a
    broadcast input by its distinct elements) and every output written
    once. Views cost nothing (ops whose results alias an input: ``view``,
    ``reshape``, ``expand``, ``transpose``, slicing, ``detach``); ``empty``
    nothing; a factory or fill writes its output only; ``copy_`` reads its
    source and writes its destination; a gather (``index``,
    ``index_select``, ``gather``, ``embedding``) reads and writes its result
    and reads its index; a scatter (``index_put_``, ``index_add_``,
    ``scatter*``) reads and writes its updates (and reads the rows it adds
    to), reads its index, and an out-of-place one also copies its input.
    Unlike the reference's fused-program model, every elementwise result is
    a write to memory: the port's memory term is what its eager program
    moves;
  - collectives: every c10d op the rank issues (``MeshComm``'s all-reduce,
    all-gather and reduce-scatter, ``merge_attention``'s all-gather), its
    payload the result's bytes on this rank (the gathered tensor of an
    all-gather, the shard of a reduce-scatter), weighted by the ring factor
    of its process group's size, by kind and by kind and group size
    (``model.collective_bytes``); payload and operands count as traffic too;
  - buckets: the flops and traffic of the ops inside each
    ``models.common.cost_scope`` (one hand-written kernel's region,
    ``kernel_credit``), collectives excepted, as in the reference;
  - peak live bytes: the storages alive at once (meta storages by their
    size), from the step's arguments (``OpCounter(args=...)``) and every
    storage an op makes, freed when its last tensor goes. Inside a kernel's
    region only what the region hands out counts (its outputs and what its
    backward saves): a plain version's temporaries (whole score matrices,
    per-expert f32 copies) stand for a kernel's on-chip tiles.

Importing this module starts nothing.
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.common import current_cost_repeat, current_cost_scope

from .model import collective_bytes

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "sigmoid", "rsqrt", "sqrt", "pow",
    "sin", "cos", "erf", "erfc", "atan2", "silu", "softplus", "gelu", "logit",
}
_DOT = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
_NO_FLOPS = {"clone", "copy", "fill", "zero", "lift_fresh_copy", "_to_copy"}
_SOFTMAX = {"_softmax": 8.0, "_log_softmax": 8.0, "_softmax_backward_data": 4.0, "_log_softmax_backward_data": 4.0}
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize", "set"}
_WRITE_ONLY = {
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full",
    "fill", "zero", "arange", "scalar_tensor", "randn", "rand", "randint", "normal", "uniform", "bernoulli",
}
_GATHER = {"index", "index_select", "gather", "embedding"}
_SCATTER = {"index_put", "_index_put_impl", "index_copy", "scatter", "index_add", "scatter_add", "scatter_reduce"}
_SCATTER_ADDS = {"index_add", "scatter_add", "scatter_reduce"}

# the c10d ops the port issues (dist.comm.MeshComm, optim.compress): their
# kind, and the index of the argument that holds the result
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
}


def _tensors(x):
    """The plain tensors of an argument: a tensor, or lists of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _unique_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor shows (a broadcast dimension,
    stride 0, once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _bytes(ts) -> int:
    return sum(_unique_bytes(t) for t in ts)


def _numel(ts) -> int:
    return sum(t.numel() for t in ts)


_VIEW_CACHE: dict = {}
_COMPOSITE_CACHE: dict = {}


def _composite(func) -> bool:
    """Whether ``func`` is made of other ATen ops (``matmul``, ``einsum``,
    ``softmax``, ``reshape``): autograd takes such ops apart before a mode
    sees them, inference mode does not."""
    hit = _COMPOSITE_CACHE.get(func)
    if hit is None:
        hit = torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), "CompositeImplicitAutograd")
        _COMPOSITE_CACHE[func] = hit
    return hit


def _is_view(func) -> bool:
    """Whether every result of ``func`` aliases an input without a write."""
    hit = _VIEW_CACHE.get(func)
    if hit is None:
        rets = func._schema.returns
        hit = bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write for r in rets)
        _VIEW_CACHE[func] = hit
    return hit


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name().endswith("ProcessGroup"):
            return torch.distributed.ProcessGroup.unbox(a).size()
    raise ValueError("a c10d op without a process group")


class OpCounter(TorchDispatchMode):
    """Counts what the ops dispatched inside ``with OpCounter(args=...)``
    compute, move and hold (module docstring); ``costs()`` reads them.
    ``args``: trees (dicts, lists, tuples) of the tensors alive before the
    run, the step's arguments (DTensors by their local shards)."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.traffic = 0.0
        self.collective_ops = []  # (kind, payload bytes, group size), as collective_bytes reads them
        self.buckets = defaultdict(lambda: {"flops": 0.0, "traffic_bytes": 0.0})
        self.n_ops = 0
        self._storages: dict = {}  # id(storage) -> bytes, while alive
        self._pending: set = set()  # made inside a kernel's region, not yet handed out
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        for t in _leaves(args):
            self.argument_bytes += self._hold(t, None) or 0

    # -- liveness -------------------------------------------------------------
    def _hold(self, t: torch.Tensor, scope):
        """Track the storage of ``t`` (first sight only); returns its bytes
        when it was new."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return None
        nb = st.nbytes()
        self._storages[key] = nb
        weakref.finalize(st, self._free, key)
        if scope is None:
            self.live += nb
            self.peak = max(self.peak, self.live)
        else:
            self._pending.add(key)
        return nb

    def _free(self, key) -> None:
        nb = self._storages.pop(key, 0)
        if key in self._pending:
            self._pending.discard(key)
        else:
            self.live -= nb

    def _settle(self) -> None:
        """A region has ended: what it made and still lives is live."""
        for key in self._pending:
            self.live += self._storages[key]
        self._pending.clear()
        self.peak = max(self.peak, self.live)

    # -- dispatch ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):  # reached here in inference mode: count the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = [t for a in (*args, *kwargs.values()) for t in _tensors(a)]
        if any(type(t) is not torch.Tensor for t in ins):
            return out  # a tensor subclass (DTensor) dispatches its own local ops
        outs = list(_tensors(out))
        scope, rep = current_cost_scope(), current_cost_repeat()
        if scope is None and self._pending:
            self._settle()
        for t in ins:
            self._hold(t, None)
        if func.namespace == "c10d":
            self._collective(func, args, ins, rep)
        else:
            flops, dot, traffic = self._op(func, args, kwargs, ins, outs)
            self.flops += flops * rep
            self.dot_flops += dot * rep
            self.traffic += traffic * rep
            if scope is not None and (flops or traffic):
                b = self.buckets[scope]
                b["flops"] += flops * rep
                b["traffic_bytes"] += traffic * rep
        self.n_ops += 1
        for t in outs:
            self._hold(t, scope)
        return out

    def _collective(self, func, args, ins, rep: int) -> None:
        name = func.overloadpacket.__name__
        if name not in _C10D:
            raise NotImplementedError(f"c10d.{name}: a collective the counter does not price")
        kind, at = _C10D[name]
        n = _group_size(args)
        result = list(_tensors(args[at]))
        payload = _bytes(result)
        self.collective_ops += [(kind, payload, n)] * rep
        read = [t for t in ins if not any(t is r for r in result)] or result  # in place: the result is read too
        self.traffic += (payload + _bytes(read)) * rep

    def _op(self, func, args, kwargs, ins, outs):
        """(flops, dot flops, traffic bytes) of one op."""
        if not outs or _is_view(func) or (not func._schema.is_mutable and self._aliases(ins, outs)):
            return 0.0, 0.0, 0.0
        name = func.overloadpacket.__name__
        inplace = name.endswith("_") and not name.endswith("__")
        base = name[:-1] if inplace else name
        # flops
        flops = dot = 0.0
        if base in _DOT:
            a = args[1] if base in ("addmm", "baddbmm") else args[0]
            k = a.numel() if base == "dot" else a.shape[-1]
            dot = 2.0 * _numel(outs) * k
            flops = dot + (_numel(outs) if base in ("addmm", "baddbmm") else 0)
        elif base in _SOFTMAX:
            flops = _SOFTMAX[base] * _numel(outs)
        elif torch.Tag.reduction in func.tags:
            flops = float(ins[0].numel()) if ins else 0.0
            if base == "logsumexp":
                flops *= 7.0  # max, subtract, exp (4), sum
        elif torch.Tag.pointwise in func.tags and base not in _NO_FLOPS:
            flops = (4.0 if base in _TRANSCENDENTAL else 1.0) * _numel(outs)
        # traffic
        if base in _EMPTY:
            traffic = 0
        elif base in _WRITE_ONLY:
            traffic = _bytes(outs)
        elif base == "copy":
            traffic = _bytes(ins[:2])
        elif base in _GATHER:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            traffic = 2 * _bytes(outs) + _bytes(idx)
        elif base in _SCATTER:
            self_t, rest = ins[0], ins[1:]
            idx = [t for t in rest if not t.is_floating_point() and t.dtype != self_t.dtype]
            src = [t for t in rest if not any(t is i for i in idx)]
            traffic = (3 if base in _SCATTER_ADDS else 2) * _bytes(src) + _bytes(idx)
            if not inplace:
                traffic += _unique_bytes(self_t) + _bytes(outs)
        else:
            traffic = _bytes(ins) + _bytes(outs)
        return flops, dot, float(traffic)

    @staticmethod
    def _aliases(ins, outs) -> bool:
        """Whether every result lies in an input's storage (``_unsafe_view``)."""
        keys = {id(t.untyped_storage()) for t in ins}
        return all(id(t.untyped_storage()) in keys for t in outs)

    # -- results ----------------------------------------------------------------
    def costs(self) -> dict:
        """The counts, in the keys of the reference's ``hlo_costs``, and
        ``dot_flops``, ``other_flops``, ``peak_bytes``, ``argument_bytes``
        and ``n_ops``."""
        self._settle()
        coll = collective_bytes(self.collective_ops)
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "other_flops": self.flops - self.dot_flops,
            "traffic_bytes": self.traffic,
            "collectives": coll,
            "collective_bytes": coll["total_bytes"],
            "collective_weighted_bytes": coll["total_weighted"],
            "buckets": {k: dict(v) for k, v in self.buckets.items()},
            "peak_bytes": float(self.peak),
            "argument_bytes": float(self.argument_bytes),
            "n_ops": self.n_ops,
        }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree.to_local() if type(tree) is not torch.Tensor and hasattr(tree, "to_local") else tree

