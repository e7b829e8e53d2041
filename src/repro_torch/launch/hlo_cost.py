"""Per-device cost model of one eager step: FLOPs, HBM bytes, collective
bytes and memory, loop-aware by construction.

Port of ``repro/launch/hlo_cost.py``, whose name it keeps so that a reader
finds its counterpart.  There is no HLO here.  The reference parses XLA's
optimized program and weights a ``while`` body by its trip count, because
``cost_analysis()`` counts it once; an eager or DTensor step dispatches
every operator of every iteration, so counting what is dispatched already
counts each loop as often as it runs.  :class:`Counters` is a
``TorchDispatchMode`` that sees each operator once, after the autograd and
composite decompositions (``matmul``/``einsum``/``linear`` arrive as
``mm``/``bmm``/``addmm``) and before the kernel.

All quantities are PER DEVICE, like the reference's (the compiled module is
the per-device SPMD program): the mode counts only the local operators that
a DTensor dispatches on this rank, never the DTensor-level operator (it
returns ``NotImplemented`` to a DTensor, which then runs its local
operators, which the mode sees), and it pauses while DTensor's sharding
propagation runs the operator on whole-size fake tensors to learn its
output's shape.  On the ``fake`` process group this rank is rank 0, which
holds the largest shard under torch's chunk rule, as XLA's padded shard
does.

Per operator:

- FLOPs: only the reference's classes, ``dot`` and ``convolution``: the
  operators that ``torch.utils.flop_counter`` has formulas for (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``_scaled_mm``, the convolutions and the
  fused attention kernels), by those formulas; no elementwise FLOPs, so
  that the two counts compare;
- HBM bytes: what an eager program moves, the bytes of each operator's
  tensor operands (the elements a broadcast operand spans) and results,
  with the reference's rules where they have a counterpart: views,
  aliases, ``as_strided``, ``expand``, ``detach`` and allocations count 0
  (like ``bitcast``/``get-tuple-element``/``parameter``); an in-place
  write into part of a tensor (``copy_`` into a view, ``index_put_``,
  ``index_copy_``, ``scatter_``, ``slice_scatter``, ...) counts twice the
  update (``copy_``: the source read and the destination written); a
  gather or index read (``index``, ``gather``, ``embedding``, ...) counts
  twice the result; a fill counts its result once; a copy between host
  and device (the CPU-built tables a card's step uploads) is not device
  memory traffic of the step and is counted apart (``transfer_bytes``),
  so that a card's count equals the CPU's.  The reference counts
  XLA's fused program and this the unfused one, so the two differ by
  design;
- collectives: c10d's functional operators by the reference's kinds
  (``all_reduce`` -> all-reduce, ``all_gather_into_tensor`` -> all-gather,
  ``reduce_scatter_tensor`` -> reduce-scatter, ``all_to_all_single`` ->
  all-to-all, point-to-point -> collective-permute; the legacy ``c10d``
  operators likewise), bytes = the local operand's bytes.  What maps to
  none of them (the ``scatter_``/``broadcast_`` of a ``distribute_tensor``
  of a plain input) is counted in ``warnings`` by name, not dropped.  The
  mode counts them itself (no ``CommDebugMode``).  A redistribute from one
  sharded dimension to another (DTensor's ``shard_dim_alltoall``) counts
  as one all-to-all of its input on every device: a CUDA mesh runs it as
  one operator (``_dtensor.shard_dim_alltoall``), a CPU mesh as an
  all-gather and a chunk (gloo has no all-to-all), and neither inner
  form is counted, so that a cell counts alike on fake ``cuda`` and fake
  ``cpu`` tensors;
- transcendentals: the elements of exp/log/tanh/sigmoid/rsqrt/erf-class
  results (``silu``, ``softmax`` and ``gelu`` included);
- memory (``memory()``): the local bytes of the arguments the step reads,
  the outputs' and the outputs that are arguments (``alias_bytes``), and
  the peak of live local storage during the run, above (``temp_bytes``)
  and including (``peak_bytes``) the arguments read, from a
  ``weakref.finalize`` on every storage an operator creates.  An argument
  counts as read, as XLA keeps an argument (``jax.jit``'s
  ``keep_unused=False`` drops the rest), when an operator takes its
  storage, or a view of it, as an input before those bytes were written;
  the destination of a ``copy_``/``fill_``/``zero_`` or an ``out=`` is
  written, not read, and an in-place update into part of it
  (``index_copy_``, ``add_``, ...) reads it.  A written argument whose
  bytes the step does not overwrite whole, and an argument the step
  returns without overwriting it whole, count as read: their old bytes
  flow to the output.  ``read(t)`` says whether ``t``'s storage was read.

``n_computations`` is, in the port, the number of local operators
dispatched.  ``Counters.weighted(n)`` weights what is counted inside it by
``n``, as the reference weights a loop body by its trip count: a train
step's microbatch loop runs one trip under it (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# operator name (namespace.name) -> the reference's collective kind
_KIND = {
    **{f"_c10d_functional.{n}": "all-reduce" for n in (
        "all_reduce", "all_reduce_", "all_reduce_coalesced",
        "all_reduce_coalesced_")},
    **{f"_c10d_functional.{n}": "all-gather" for n in (
        "all_gather_into_tensor", "all_gather_into_tensor_out",
        "all_gather_into_tensor_coalesced")},
    **{f"_c10d_functional.{n}": "reduce-scatter" for n in (
        "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced")},
    "_c10d_functional.all_to_all_single": "all-to-all",
    **{f"c10d.{n}": "all-reduce" for n in ("allreduce_",
                                            "allreduce_coalesced_")},
    **{f"c10d.{n}": "all-gather" for n in (
        "allgather_", "_allgather_base_", "allgather_into_tensor_coalesced_",
        "allgather_coalesced_")},
    **{f"c10d.{n}": "reduce-scatter" for n in (
        "reduce_scatter_", "_reduce_scatter_base_",
        "reduce_scatter_tensor_coalesced_")},
    **{f"c10d.{n}": "all-to-all" for n in ("alltoall_", "alltoall_base_")},
    **{f"c10d.{n}": "collective-permute" for n in (
        "send", "recv_", "recv_any_source_")},
}
_NOT_COUNTED = {"_c10d_functional.wait_tensor", "c10d.barrier"}

# no data moved: allocations, aliases the schema does not mark, metadata
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
         aten.arange, aten.set_, aten.resize_, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
         aten.equal}
_FILLS = {aten.fill_, aten.zero_, aten.zeros, aten.ones, aten.full,
          aten.zeros_like, aten.ones_like, aten.full_like, aten.new_zeros,
          aten.new_ones, aten.new_full, aten.scalar_tensor}
# in-place writes into part of a tensor: the argument index of the update
_UPDATES = {aten.index_put_: 2, aten.index_put: 2, aten._index_put_impl_: 2,
            aten.index_copy_: 3, aten.index_copy: 3, aten.index_add_: 3,
            aten.index_add: 3, aten.scatter_: 3, aten.scatter: 3,
            aten.scatter_add_: 3, aten.scatter_add: 3,
            aten.scatter_reduce_: 3, aten.scatter_reduce: 3,
            aten.slice_scatter: 1, aten.select_scatter: 1,
            aten.diagonal_scatter: 1, aten.as_strided_scatter: 1,
            aten.masked_scatter_: 2}
# operators that overwrite their first argument without reading it
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}
_READS = {aten.index, aten._unsafe_index, aten.index_select, aten.gather,
          aten.embedding, aten.take, aten.take_along_dim}
_TRANSCENDENTAL = {aten.exp, aten.exp_, aten.exp2, aten.expm1, aten.log,
                   aten.log_, aten.log2, aten.log10, aten.log1p, aten.tanh,
                   aten.tanh_, aten.sigmoid, aten.sigmoid_, aten.rsqrt,
                   aten.rsqrt_, aten.sqrt, aten.sqrt_, aten.erf, aten.erf_,
                   aten.erfc, aten.sin, aten.cos, aten.silu, aten.silu_,
                   aten.silu_backward, aten.gelu, aten.gelu_backward,
                   aten._softmax, aten._log_softmax, aten.softplus,
                   aten._safe_softmax}


def _spanned_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` reads: a broadcast (stride 0)
    dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _crosses(args, out) -> bool:
    """Whether a copy's source and result lie on different devices."""
    src = args[1] if len(args) > 1 and isinstance(args[1], torch.Tensor) \
        else args[0]
    return any(t.device != src.device for t in _tensors(out))


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples, dataclasses and
    modules (a module's parameters and buffers), local shards of DTensors."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(_local(x))
        elif isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                out.append(_local(t))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))
    walk(tree)
    return out


def _host_work():
    """What DTensor runs beside an operator's local computation, as
    (class, method, on host integers): the propagation of its output's
    shape on whole-size fake tensors, and ``_StridedShard``'s offsets,
    which it computes from an ``arange`` (which a fake tensor cannot give
    back, so it runs on real host tensors).  Neither is counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    out = []
    for name in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"):
        if name in vars(ShardingPropagator):
            out.append((ShardingPropagator, name, False))
            break
    else:
        raise RuntimeError("this torch's DTensor has no tensor-meta "
                           "propagation method to pause the counters in; "
                           "per-device counts would include whole-size "
                           "operators")
    if "local_shard_size_and_offset" in vars(_StridedShard):
        out.append((_StridedShard, "local_shard_size_and_offset", True))
    return out


def _alltoall_sites():
    """The modules that bind DTensor's ``shard_dim_alltoall`` (its own and
    the placements' that call it), to count it as one all-to-all."""
    import importlib

    out = []
    for mod in ("torch.distributed.tensor._collective_utils",
                "torch.distributed.tensor.placement_types"):
        m = importlib.import_module(mod)
        if "shard_dim_alltoall" in vars(m):
            out.append(m)
    return out


class Counters(TorchDispatchMode):
    """The counters, as a dispatch mode: ``with Counters() as c: step()``."""

    def __init__(self):
        super().__init__()
        self.weight = 1
        self.paused = 0
        self.flops = 0.0
        self.bytes_hbm = 0.0
        self.transcendentals = 0.0
        self.transfer_bytes = 0.0  # host <-> device copies, apart
        self.n_ops = 0.0
        self.coll = {k: {"count": 0.0, "bytes": 0.0} for k in _COLLECTIVES}
        self.coll_once = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
        self.top: list = []
        self.unmapped: dict = defaultdict(int)
        self.by_op: dict = defaultdict(lambda: [0.0, 0.0, 0.0])
        self._arg_storages: dict = {}
        self._read: set = set()
        self._written: dict = {}  # argument storage -> [lo, hi) bytes written
        self._live = 0
        self.peak_live = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self._seen: dict = {}
        self._restore = []

    # -- scope ---------------------------------------------------------------

    def __enter__(self):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        self._restore = []
        for cls, name, real in _host_work():
            inner = vars(cls)[name]
            fn = inner.__func__ if isinstance(inner, staticmethod) else inner

            def paused(*a, _fn=fn, _real=real, **k):
                self.paused += 1
                try:
                    with (unset_fake_temporarily() if _real
                          else contextlib.nullcontext()):
                        return _fn(*a, **k)
                finally:
                    self.paused -= 1

            setattr(cls, name, staticmethod(paused)
                    if isinstance(inner, staticmethod) else paused)
            self._restore.append((cls, name, inner))
        for mod in _alltoall_sites():
            inner = vars(mod)["shard_dim_alltoall"]

            def alltoall(t, gather_dim, shard_dim, mesh, mesh_dim, _fn=inner):
                self._access(t, False)
                self.paused += 1
                try:
                    out = _fn(t, gather_dim, shard_dim, mesh, mesh_dim)
                finally:
                    self.paused -= 1
                if not self.paused:
                    self.n_ops += self.weight
                    self._collective("all-to-all",
                                     "_dtensor.shard_dim_alltoall", [t], out)
                    self._track(out)
                return out

            setattr(mod, "shard_dim_alltoall", alltoall)
            self._restore.append((mod, "shard_dim_alltoall", inner))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for cls, name, inner in self._restore:
                setattr(cls, name, inner)

    @contextlib.contextmanager
    def weighted(self, n: int):
        """Weight what is counted inside by ``n`` (a loop body run once for
        ``n`` trips)."""
        before = self.weight
        self.weight = before * n
        try:
            yield
        finally:
            self.weight = before

    # -- memory --------------------------------------------------------------

    def arguments(self, *trees):
        """Record the step's arguments: their local storages are live from
        the start and are not new when an operator returns them."""
        for t in _leaves(trees):
            st = t.untyped_storage()
            self._arg_storages.setdefault(id(st), st)

    def outputs(self, *trees):
        """Record the step's outputs (``output_bytes``, ``alias_bytes``);
        an argument among them that the step did not overwrite whole
        counts as read."""
        seen = set()
        for t in _leaves(trees):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            self.output_bytes += st.nbytes()
            if id(st) in self._arg_storages:
                self.alias_bytes += st.nbytes()
                if not self._covered(id(st), 0, st.nbytes()):
                    self._read.add(id(st))

    def read(self, t: torch.Tensor) -> bool:
        """Whether the step read the argument ``t`` (a local shard of a
        DTensor): see the module's docstring."""
        return self._kept(id(_local(t).untyped_storage()))

    def _kept(self, key) -> bool:
        if key in self._read:
            return True
        # written, but not whole: the old bytes flow to the output
        return key in self._written and not self._covered(
            key, 0, self._arg_storages[key].nbytes())

    @property
    def argument_bytes(self) -> int:
        """The local bytes of the arguments read."""
        return sum(st.nbytes() for key, st in self._arg_storages.items()
                   if self._kept(key))

    def _covered(self, key, lo, hi) -> bool:
        return any(a <= lo and hi <= b for a, b in self._written.get(key, ()))

    def _note_access(self, func, args, kwargs):
        """Mark the argument storages ``func`` reads or overwrites."""
        packet = func._overloadpacket
        if (func.is_view or func.namespace == "prim" or packet in _FREE
                or (packet in _FILLS and packet not in _OVERWRITES)):
            return  # metadata, allocations and aliases read no bytes
        for i, a in enumerate(func._schema.arguments):
            val = args[i] if i < len(args) else kwargs.get(a.name)
            written = a.alias_info is not None and a.alias_info.is_write
            over = written and (a.is_out or (i == 0 and packet in _OVERWRITES))
            for t in _tensors(val):
                self._access(t, over)

    def _access(self, t, overwrite: bool):
        key = id(t.untyped_storage())
        if key not in self._arg_storages or key in self._read \
                or t.numel() == 0:
            return
        size = t.element_size()
        lo = t.storage_offset() * size
        hi = lo + size * (1 + sum((n - 1) * s for n, s in
                                  zip(t.shape, t.stride())))
        if not overwrite:
            if not self._covered(key, lo, hi):
                self._read.add(key)
            return
        spans = self._written.setdefault(key, [])
        if not t.is_contiguous():  # some bytes of [lo, hi) stay
            return
        spans.append((lo, hi))
        spans.sort()
        merged = [spans[0]]
        for a, b in spans[1:]:
            if a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        spans[:] = merged

    def _track(self, out):
        for t in _tensors(out):
            if isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._arg_storages or key in self._seen:
                continue
            nb = st.nbytes()
            self._seen[key] = nb
            self._live += nb
            self.peak_live = max(self.peak_live, self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self._live -= self._seen.pop(key, 0)

    def memory(self) -> dict:
        """The reference's ``memory_analysis()`` fields, per device."""
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.peak_live,
                "alias_bytes": self.alias_bytes,
                "peak_bytes": self.argument_bytes + self.peak_live}

    # -- counting ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local operators
        if self._arg_storages:
            self._note_access(func, args, kwargs)
        out = func(*args, **kwargs)
        if self.paused:
            return out
        self._count(func, args, kwargs, out)
        self._track(out)
        return out

    def _collective(self, kind, label, ins, out):
        """One collective of ``kind`` on the local operands ``ins``."""
        w = self.weight
        nb = sum(t.numel() * t.element_size() for t in ins)
        self.coll[kind]["count"] += w
        self.coll[kind]["bytes"] += w * nb
        self.coll_once[kind]["count"] += 1
        self.coll_once[kind]["bytes"] += nb
        shapes = ", ".join(f"{str(t.dtype).removeprefix('torch.')}"
                           f"{list(t.shape)}" for t in ins)
        self.top.append((w * nb, nb, kind, f"{label}({shapes})"[:200]))
        self.bytes_hbm += w * (nb + sum(
            t.numel() * t.element_size() for t in _tensors(out)))

    def _count(self, func, args, kwargs, out):
        w = self.weight
        packet = func._overloadpacket
        name = f"{func.namespace}.{packet.__name__}"
        if func.namespace in ("_c10d_functional", "c10d"):
            if name in _NOT_COUNTED:
                return
            self.n_ops += w
            ins = _tensors((args, kwargs))
            kind = _KIND.get(name)
            if kind is None:
                self.unmapped[name] += 1
                return
            self._collective(kind, str(func), ins, out)
            return
        if func.namespace == "prim":
            return
        self.n_ops += w
        if packet in (aten._to_copy, aten.copy_) and _crosses(args, out):
            # a copy between host and device: no traffic of the device's
            # memory that a one-device count would hold (the CPU has none)
            self.transfer_bytes += w * sum(
                t.numel() * t.element_size() for t in _tensors(out))
            self.by_op["transfer " + name][0] += w
            return
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = self._bytes(func, packet, args, kwargs, out)
        self.flops += w * flops
        self.bytes_hbm += w * nbytes
        if packet in _TRANSCENDENTAL:
            self.transcendentals += w * sum(t.numel() for t in _tensors(out))
        rec = self.by_op[name]
        rec[0] += w
        rec[1] += w * flops
        rec[2] += w * nbytes

    @staticmethod
    def _bytes(func, packet, args, kwargs, out) -> int:
        if func.is_view or packet in _FREE:
            return 0
        if packet in _FILLS:
            return sum(t.numel() * t.element_size() for t in _tensors(out))
        if packet is aten.copy_:
            return _spanned_bytes(args[1]) + _spanned_bytes(args[0])
        if packet in _UPDATES:
            i = _UPDATES[packet]
            upd = args[i] if len(args) > i else None
            if not isinstance(upd, torch.Tensor):  # scatter of a scalar
                upd = args[2]  # one value per index
            return 2 * _spanned_bytes(upd)
        if packet in _READS:
            return 2 * sum(t.numel() * t.element_size()
                           for t in _tensors(out))
        return (sum(_spanned_bytes(t) for t in _tensors((args, kwargs)))
                + sum(t.numel() * t.element_size() for t in _tensors(out)))

    def report(self) -> dict:
        """The reference's ``analyze`` keys."""
        top = sorted(self.top, key=lambda r: -r[0])
        return {
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "collectives": {k: dict(v) for k, v in self.coll.items()},
            "collective_bytes_total": sum(v["bytes"]
                                          for v in self.coll.values()),
            "top_collectives": [{"bytes": b, "kind": k, "hlo": h}
                                for b, _, k, h in top[:12]],
            "warnings": [f"{n}: {c} call(s) of no collective kind"
                         for n, c in sorted(self.unmapped.items())][:10],
            "n_computations": int(self.n_ops),
        }


def analyze(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once under the counters; the reference's
    keys (``flops``, ``bytes_hbm``, ``collectives``,
    ``collective_bytes_total``, ``top_collectives``, ``warnings``,
    ``n_computations``), per device."""
    with Counters() as c:
        fn(*args, **kw)
    return c.report()
