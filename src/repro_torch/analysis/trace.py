"""Per-device accounting of a dispatched step: FLOPs, memory traffic and
collectives.

The reference's ``analysis/hlo.py`` parses the compiled XLA module; PyTorch
has no HLO, so this module has no twin there. Its counterpart records the
step as it is dispatched, under a ``TorchDispatchMode``:

  * every op on a plain tensor (a ``DTensor`` op is let through to DTensor,
    which runs it as ops on each rank's local shards, and those are what is
    recorded): so every number is **per device**, as the reference's
    post-SPMD shapes are;
  * FLOPs: PyTorch's own per-op formulas (``torch.utils.flop_counter``:
    products, convolutions, attention), 2 a multiply-add;
  * traffic bytes: each op's tensor inputs plus its outputs (in eager mode
    every op is a kernel that reads and writes memory); views and
    allocations move nothing and are left out;
  * collectives: the ``_c10d_functional`` ops DTensor issues (and ``c10d``'s
    own), each with its operand bytes (its input, as the reference counts a
    collective's operand) and ring-estimated wire bytes, as the reference:

      all-gather: (N-1)/N·out   reduce-scatter: (N-1)/N·in
      all-reduce: 2(N-1)/N·out  all-to-all: (N-1)/N·out   broadcast: out

  * live bytes: a high-water mark of the bytes of the tensors the step
    makes and still holds (``peak_temp_bytes``): an op's output counts
    from the op that makes its storage until that storage is freed (a
    ``weakref.finalize`` on it); a view or an in-place write shares its
    input's storage and counts nothing, and neither do the step's
    arguments. Autograd's saved tensors and a checkpoint's recomputation
    count as they live in an eager run. It is the eager program's high
    water, not XLA's buffer assignment of a fused one, and leaves out
    what no op returns (a library's workspace, the allocator's rounding).

DTensor's sharding propagation infers output shapes by running the global
op on ``meta`` tensors or on fake tensors (its own, or, the first time it
meets a shape, the dry-run's): those run no kernel and are not recorded,
nor is anything DTensor's propagation or ``DeviceMesh`` dispatches for
themselves (caches filled the first time, so a process's first step would
count more than the next). The dry-run's own fake tensors (``fake_mode``)
are recorded: nothing is allocated, and the counts are those of a real
run.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: Collective ops by name (the ``_c10d_functional`` and ``c10d`` ones) ->
#: the reference's collective kinds.
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "scatter_": "broadcast",
}
#: DTensor's own bookkeeping: ops dispatched from these modules are not the
#: step's (``_bookkeeping``).
_BOOKKEEPING = ("_sharding_prop.py", "device_mesh.py")
#: Ops that move no data: allocations, metadata, waits.
_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "_local_scalar_dense",
               "wait_tensor", "empty_like", "set_", "resize_",
               "_unsafe_view"}


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _stack(lines: bool) -> tuple:
    """One walk of the Python stack above the dispatch -> (whether DTensor's
    sharding propagation or ``DeviceMesh`` is on it, so the op is theirs,
    not the step's; with ``lines``, this package's lines on it, innermost
    first, else ``None``)."""
    out = [] if lines else None
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.endswith(_BOOKKEEPING):
            return True, out
        if lines and "repro_torch" in name and not name.endswith("trace.py"):
            out.append(f"{name.rsplit('/', 1)[-1]}:{f.f_lineno}")
        f = f.f_back
    return False, out


def _site(func, lines: list, outs) -> str:
    """Where an allocation happens: the op, the lines of this package on
    the Python stack, and the outputs' shapes but their first dim (a
    stacked weight's leading dim is the depth). A repeated layer's
    allocations share a site."""
    return f"{func}|{'<'.join(lines)}|{[tuple(t.shape[1:]) for t in outs]}"


def _storages(tree) -> list:
    """The storages of the tensors in ``tree`` (a ``DTensor``'s local
    shard's), each once. A storage's Python object lives as long as the
    storage itself, so its ``id`` names it while it lives."""
    from torch.distributed.tensor import DTensor

    out = {}
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        out[id(st)] = st
    return list(out.values())


def _group_size(args) -> int:
    """A functional collective's group size: its explicit ``group_size``
    argument, else the size of the group it names."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
    names = [a for a in args if isinstance(a, str)]
    if names:
        try:
            return _resolve_process_group(names[-1]).size()
        except (RuntimeError, ValueError, KeyError):
            pass
    return ints[-1] if ints else 1


def _wire_bytes(kind: str, out_b: int, in_b: int, n: int) -> int:
    n = max(n, 1)
    if kind == "all-gather":
        return (n - 1) * out_b // n
    if kind == "reduce-scatter":
        return (n - 1) * in_b // n
    if kind == "all-reduce":
        return 2 * (n - 1) * out_b // n
    if kind == "all-to-all":
        return (n - 1) * out_b // n
    return out_b


@dataclass
class TraceStats:
    """What one traced run dispatched on this device."""

    flops: int = 0
    traffic_bytes: int = 0
    coll_operand_bytes: int = 0
    coll_wire_bytes: int = 0
    coll_count: int = 0
    ops: int = 0                      # ops recorded (kernels, in eager mode)
    peak_temp_bytes: int = 0          # high water of the step's own tensors
    per_op: dict = field(default_factory=dict)
    collectives: list = field(default_factory=list)
    flops_by_op: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "flops": self.flops,
            "traffic_bytes": self.traffic_bytes,
            "coll_operand_bytes": self.coll_operand_bytes,
            "coll_wire_bytes": self.coll_wire_bytes,
            "coll_count": self.coll_count,
            "ops": self.ops,
            "peak_temp_bytes": self.peak_temp_bytes,
            "per_op": self.per_op,
            "flops_by_op": self.flops_by_op,
        }


class StepTrace(TorchDispatchMode):
    """Records what runs under it into ``self.stats`` (a ``TraceStats``);
    ``args``: the step's arguments, whose storages are never the step's
    own; ``sites``: a dict to fill with the live bytes at each allocation
    site's high water (``_site``; the dry-run extrapolates the high water
    site by site), or ``None``."""

    def __init__(self, fake_mode=None, args=(), sites=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._fake_mode = fake_mode

        self._flop_fns = flop_registry
        self.stats = TraceStats()
        self._per_op = defaultdict(lambda: {"count": 0, "operand_bytes": 0,
                                            "wire_bytes": 0})
        self._flops_by_op = defaultdict(int)
        self._args = {id(st) for st in _storages(args)}
        self._held: set = set()             # ids of the live storages counted
        self._live = 0
        self._sites = sites

    def _take(self, func, ins, outs, lines) -> None:
        """Count each output storage the op made (not an input's, not an
        argument's, not one already counted) until it is freed; the live
        bytes after it, at the high water and at its site (``lines``: the
        op's lines of this package, when sites are kept)."""
        inputs = {id(st) for st in _storages(ins)}
        made = False
        for st in _storages(outs):
            key = id(st)
            if key in inputs or key in self._args or key in self._held:
                continue
            n = st.nbytes()
            self._held.add(key)
            self._live += n
            made = True
            weakref.finalize(st, self._free, key, n)
        if made:
            st = self.stats
            st.peak_temp_bytes = max(st.peak_temp_bytes, self._live)
            if self._sites is not None:
                site = _site(func, lines, outs)
                self._sites[site] = max(self._sites.get(site, 0), self._live)

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs it on the shards
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(t.device.type == "meta" or getattr(
                t, "fake_mode", self._fake_mode) is not self._fake_mode
               for t in ins):
            return out                      # shape inference, no kernel
        theirs, lines = _stack(self._sites is not None)
        if theirs:
            return out
        outs = _tensors(out)
        self._record(func, args, kwargs, ins, outs, out)
        self._take(func, ins, outs, lines)
        return out

    def _record(self, func, args, kwargs, ins, outs, out) -> None:
        st = self.stats
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            in_b = sum(_nbytes(t) for t in ins)
            out_b = sum(_nbytes(t) for t in outs) or in_b
            n = _group_size(args)
            wire = _wire_bytes(kind, out_b, in_b, n)
            st.coll_count += 1
            st.coll_operand_bytes += in_b
            st.coll_wire_bytes += wire
            agg = self._per_op[kind]
            agg["count"] += 1
            agg["operand_bytes"] += in_b
            agg["wire_bytes"] += wire
            st.collectives.append({"op": kind, "group_size": n,
                                   "operand_bytes": in_b, "wire_bytes": wire})
            st.per_op = dict(self._per_op)
            return
        if ns == "prim" or name in _NO_TRAFFIC or func.is_view:
            return
        st.ops += 1
        st.traffic_bytes += sum(_nbytes(t) for t in ins + outs)
        fn = self._flop_fns.get(func._overloadpacket)
        if fn is not None:
            flops = int(fn(*args, **kwargs, out_val=out))
            st.flops += flops
            self._flops_by_op[name] += flops
            st.flops_by_op = dict(self._flops_by_op)


def trace_step(fn, *args, fake_mode=None, sites=None) -> tuple:
    """Run ``fn(*args)`` under a ``StepTrace`` -> (its result, the
    ``TraceStats``); ``fake_mode``: the ``FakeTensorMode`` of ``args``' fake
    tensors, if they are fake; ``sites``: as ``StepTrace``'s."""
    mode = StepTrace(fake_mode, args, sites)
    with mode:
        out = fn(*args)
    return out, mode.stats


def parse_collectives(stats: TraceStats) -> list:
    """Every collective of a traced run, in dispatch order: ``{"op",
    "group_size", "operand_bytes", "wire_bytes"}``."""
    return list(stats.collectives)


def collective_summary(stats: TraceStats) -> dict:
    """A traced run's collectives in all and by kind."""
    return {"count": stats.coll_count,
            "operand_bytes": stats.coll_operand_bytes,
            "wire_bytes": stats.coll_wire_bytes,
            "per_op": dict(stats.per_op)}
