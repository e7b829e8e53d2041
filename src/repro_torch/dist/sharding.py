"""Logical-axis sharding rules as DTensor placements.

Port of ``repro/dist/sharding.py``.  Every parameter and cache leaf has a
tuple of *logical axis names* per dimension (``models/carry.py``:
``param_axes``, ``cache_axes``).  A :class:`Rules` object maps logical
names onto mesh axes and turns (logical axes, concrete shape) into the
reference's canonical ``PartitionSpec`` tuple (``spec``), dropping any
assignment whose mesh-axis product does not divide the dimension and never
using one mesh axis twice, and into one DTensor ``Placement`` per mesh
dimension (``placements``).  A tensor dimension mapped to several mesh
axes, ``("pod", "data")``, is ``Shard(d)`` on each of them: DTensor splits
it over the mesh dimensions in mesh order, the major-to-minor order of
JAX's ``P(("pod", "data"))``.

``Rules`` reads only the mesh's axis names and sizes, so it works on a
``DeviceMesh`` and on ``launch.mesh.Mesh`` (shape only, no ranks) alike.

Rule sets, as the reference's:

- ``train_compute_rules``  — tensor parallel over ``model``; batch over the
  data axes (``("pod", "data")`` on the multi-pod mesh).
- ``train_seqpar_rules``   — like compute, but activations shard the
  *sequence* dimension over ``model``.
- ``train_state_rules``    — ZeRO-style: master/optimizer state additionally
  sharded over the data axes on the ``d_model`` dimension.
- ``serve_rules``          — decode/prefill: KV-cache batch over data axes,
  heads over ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

AxisSpec = Union[str, tuple, None]


def mesh_shape(mesh) -> dict:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or of the
    port's shape-only ``launch.mesh.Mesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _mesh_axis_size(mesh, axes: AxisSpec) -> int:
    """Product of mesh-axis sizes a logical axis maps onto (1 for None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    out = 1
    for a in axes:
        out *= shape.get(a, 1)
    return out


def _batch_axes(mesh) -> AxisSpec:
    """Every non-model mesh axis carries batch (pod x data on multi-pod)."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if a in shape)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def placements_of(mesh, spec: tuple) -> tuple:
    """The DTensor placements of a ``PartitionSpec`` tuple: per mesh
    dimension, ``Shard(d)`` if tensor dimension ``d`` names it, else
    ``Replicate()``."""
    where = {}
    for d, entry in enumerate(spec):
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            if a in where:
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            where[a] = d
    names = list(mesh_shape(mesh))
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"{spec} names {sorted(unknown)}, not axes of the "
                         f"mesh {names}")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def spec_of(mesh, placements, ndim: int) -> tuple:
    """The canonical ``PartitionSpec`` tuple of DTensor ``placements``
    (the inverse of ``placements_of``): per tensor dimension the mesh
    axes that shard it, in mesh order; trailing ``None`` trimmed."""
    names = list(mesh_shape(mesh))
    out: list = [[] for _ in range(ndim)]
    for a, p in zip(names, placements):
        if isinstance(p, Shard):
            out[p.dim].append(a)
        elif not isinstance(p, Replicate):
            raise ValueError(f"{p} on mesh axis {a!r} is not a layout")
    spec = [None if not e else e[0] if len(e) == 1 else tuple(e)
            for e in out]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a ``PartitionSpec`` tuple: the reference's
    ``NamedSharding``, with its DTensor ``placements``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_of(self.mesh, self.spec)


@dataclasses.dataclass
class Rules:
    """Logical-axis -> mesh-axis mapping plus the spec/sharding builders."""

    mesh: Any
    rules: dict  # logical axis name -> mesh axis | tuple of mesh axes | None

    def spec(self, logical: tuple, shape: tuple) -> tuple:
        """``PartitionSpec`` tuple for one array: per-dim lookup with
        validity checks (divisibility; each mesh axis used at most once;
        the first tensor dimension wins)."""
        sizes = mesh_shape(self.mesh)
        used: set = set()
        out = []
        for name, dim in zip(logical, shape):
            mx = self.rules.get(name) if name is not None else None
            if mx is None:
                out.append(None)
                continue
            axes = (mx,) if isinstance(mx, str) else tuple(mx)
            axes = tuple(a for a in axes if a in sizes and a not in used)
            size = _mesh_axis_size(self.mesh, axes)
            if not axes or size <= 1 or int(dim) % size != 0:
                out.append(None)
                continue
            used.update(axes)
            out.append(axes[0] if len(axes) == 1 else axes)
        while out and out[-1] is None:  # canonical short spec
            out.pop()
        return tuple(out)

    def placements(self, logical: tuple, shape: tuple) -> tuple:
        """One DTensor ``Placement`` per mesh dimension."""
        return placements_of(self.mesh, self.spec(logical, shape))

    def sharding(self, logical: tuple, shape: tuple) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical, shape))


def _model_sharded(mesh, *, batch: AxisSpec, seq: AxisSpec = None,
                   extra: Optional[dict] = None) -> Rules:
    rules = {
        "batch": batch,
        "seq": seq,
        # weights: shard the "wide" dimension of each layer over model
        "d_ff": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "experts": "model",
        "expert_ff": "model",
        "d_inner": "model",
        "heads_ssm": "model",
        # replicated by default
        "d_model": None,
        "ssm_state": None,
        "ssm_proj": None,
        "dt_rank": None,
        "conv": None,
        "moe_dense": None,
        # KV-cache axes (serving)
        "cache_batch": batch,
        "cache_seq": None,
        "cache_kv_heads": "model",
        "cache_hd": None,
    }
    rules.update(extra or {})
    return Rules(mesh, rules)


def train_compute_rules(mesh) -> Rules:
    """Compute-dtype params: tensor parallel over ``model``, batch over
    data."""
    return _model_sharded(mesh, batch=_batch_axes(mesh))


def train_seqpar_rules(mesh) -> Rules:
    """Sequence parallelism: activations shard seq over ``model``; weight
    layout matches the TP rules (the math is identical)."""
    return _model_sharded(mesh, batch=_batch_axes(mesh), seq="model")


def train_state_rules(mesh) -> Rules:
    """float32 master params + optimizer moments (and ZeRO-3 compute
    params): additionally sharded over the data axes on ``d_model`` so
    state memory scales down with the full device count."""
    return _model_sharded(mesh, batch=_batch_axes(mesh),
                          extra={"d_model": _batch_axes(mesh)})


def serve_rules(mesh, *, batch: int, kv_heads: int, seq: int) -> Rules:
    """Decode/prefill: slot-batch over the data axes, heads over ``model``.
    The (batch, kv_heads, seq) hints keep the signature explicit at call
    sites; divisibility is re-checked per array in ``Rules.spec``."""
    del batch, kv_heads, seq
    return _model_sharded(mesh, batch=_batch_axes(mesh))


def _is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def tree_shardings(rules: Rules, shapes: Any, axes: Any) -> Any:
    """Map a tree (nested dicts) of logical-axes tuples and a matching tree
    of tensors (meta or real) to a tree of ``NamedSharding``s."""
    if _is_axes_leaf(axes):
        return rules.sharding(axes, tuple(shapes.shape))
    return {k: tree_shardings(rules, shapes[k], a) for k, a in axes.items()}


def batch_shardings(rules: Rules, specs: dict) -> dict:
    """Input-batch shardings: dim 0 is the global batch, dim 1 (when
    present) the sequence; trailing dims (the patch embedding width)
    replicate."""
    out = {}
    for k, v in specs.items():
        logical = ("batch",) + (("seq",) if v.ndim > 1 else ())
        logical = logical + (None,) * (v.ndim - len(logical))
        out[k] = rules.sharding(logical, tuple(v.shape))
    return out


# -- placing tensors ---------------------------------------------------------


def put(t: torch.Tensor, sharding):
    """The whole tensor ``t`` (the same on every rank) on ``sharding``: a
    ``NamedSharding`` on a ``DeviceMesh`` gives a DTensor (rank 0 of each
    mesh dimension sends, each rank keeps its own shard); one on the
    shape-only ``launch.mesh.Mesh``, or a ``torch.device``, a plain tensor
    on that device.  The port's ``jax.device_put``."""
    if isinstance(sharding, (torch.device, str)):
        return t.to(sharding)
    mesh = sharding.mesh
    if not isinstance(mesh, DeviceMesh):
        return t.to(mesh.device)
    return distribute_tensor(t.to(mesh.device_type), mesh,
                             list(sharding.placements))


def mesh_barrier(mesh: DeviceMesh):
    """Every rank of ``mesh`` waits for its rank 0: a one-element
    broadcast along each mesh dimension."""
    distribute_tensor(torch.zeros(1, device=mesh.device_type), mesh,
                      [Replicate()] * mesh.ndim).to_local()


def is_mesh_rank0(mesh: DeviceMesh) -> bool:
    return all(c == 0 for c in mesh.get_coordinate())


def constrain(t: DTensor, sharding: NamedSharding) -> DTensor:
    """``t`` redistributed to ``sharding``: the port's
    ``with_sharding_constraint``."""
    pl = tuple(sharding.placements)
    if tuple(t.placements) == pl:
        return t
    return t.redistribute(sharding.mesh, pl)


def whole_dim(t, dim: int, parts: int = 1):
    """``t`` with tensor dimension ``dim`` gathered (Replicate) if the mesh
    dimensions that shard it do not divide ``parts`` (with the default 1:
    whenever it is sharded).  DTensor cannot unflatten a dimension into
    ``parts`` rows unless each shard holds whole rows (``aten.view``
    raises "Cannot unflatten unevenly sharded tensor"; GSPMD pads), and
    has no reliable rule for indexing a table by rows that it shards
    (``aten.index.Tensor`` on a vocab-sharded embedding).  A plain tensor
    passes unchanged."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    mesh, pl = t.device_mesh, list(t.placements)
    on = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == dim]
    ways = 1
    for i in on:
        ways *= mesh.size(i)
    if parts % ways == 0:
        return t
    for i in on:
        pl[i] = Replicate()
    return t.redistribute(mesh, pl)


def local_write(buf, new):
    """(``buf``'s local shard, ``new`` laid out as ``buf`` and taken as its
    local shard), for an in-place write of ``new`` into ``buf`` shard by
    shard (a cache update).  DTensor's in-place ops cannot change the
    layout of their target, and on a view of a cache (a layer of it) they
    may write into a temporary; so the caller writes the local shards
    itself.  ``new`` must match ``buf`` on every sharded dimension.  Plain
    tensors pass unchanged."""
    if not isinstance(buf, DTensor):
        return buf, new
    mesh = buf.device_mesh
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    return buf.to_local(), new.redistribute(mesh, buf.placements).to_local()


def batch_only(t):
    """DTensor ``t`` sharded on its leading (batch) dimension alone: every
    other mesh placement made Replicate (a Partial sum reduced).  DTensor's
    own choice for some products (a residual stream sharded on
    ``d_model``, the Partial output of a row-sharded projection) leads the
    SSM's backward to a redistribute it cannot do ("from S(1) to
    P(sum)"); GSPMD reaches the same layouts by all-reduce.  A plain
    tensor passes unchanged."""
    if not isinstance(t, DTensor):
        return t
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in t.placements]
    if list(t.placements) == pl:
        return t
    return t.redistribute(t.device_mesh, pl)


def summed(t, like=None):
    """The output of a row-split product (``wo`` of the attention or the
    MLP, a Mamba mixer's ``out_proj``), a Partial sum over the model
    axis, reduced before the residual add, as GSPMD sums it after
    Megatron's row-split products.  Left Partial, the residual stream
    reaches the next norm and every column-split product
    (``wq``/``wk``/``wv``/``wi``/``wg``, the LM head) as a Partial sum,
    and DTensor splits the product's contraction instead of its columns.
    Where autograd records nothing (serving) ``t`` is ``batch_only``.  In
    a train step each Partial placement is all-reduced, and the gradient
    goes back Replicate there (the residual's gradient, a Partial sum of
    the column-split products' input gradients, all-reduced), so that
    the product's backward, its weight gradient included, runs on the
    rank's own rows; left Partial, both ran whole on every rank.  A mesh
    dimension that splits ``like``, the residual the sum joins, is left
    to DTensor's add, which reduce-scatters onto it (sequence
    parallelism).  A plain tensor, or one on a model axis of 1, passes
    unchanged."""
    if not torch.is_grad_enabled():
        return batch_only(t)
    if not isinstance(t, DTensor):
        return t
    split = (tuple(like.placements) if isinstance(like, DTensor)
             else (None,) * t.device_mesh.ndim)
    js = [j for j, (p, q) in enumerate(zip(t.placements, split))
          if isinstance(p, Partial) and not isinstance(q, Shard)]

    def replicated(x):
        pl = list(x.placements)
        for j in js:
            pl[j] = Replicate()
        if pl == list(x.placements):
            return x
        return x.redistribute(x.device_mesh, pl)

    return _relaid(t, replicated, replicated) if js else t


class _Relaid(torch.autograd.Function):
    """``fwd(t)``, whose backward lays the gradient out with ``bwd``."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        out = fwd(t)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _same(t):
    return t


def _relaid(t, fwd, bwd):
    if not isinstance(t, DTensor):
        return t
    if not (torch.is_grad_enabled() and t.requires_grad):
        return fwd(t)
    return _Relaid.apply(t, fwd, bwd)


def gathered(t, dim: int):
    """``whole_dim(t, dim)``, whose gradient goes back in the layout it
    arrives in (DTensor's own redistribute would lay it out as ``t``
    again).  For an operand gathered only so that a product can fold
    ``dim`` into the dimension before it: the gradient the product's
    backward gives then reaches the layers before it as it would without
    the gather.  A plain tensor passes unchanged."""
    return _relaid(t, lambda x: whole_dim(x, dim), _same)


def grad_whole_dim(t, dim: int, parts: int = 1):
    """``t`` itself, whose gradient is laid out by ``whole_dim(g, dim,
    parts)`` on its way back.  Placed after an operation whose backward
    reshapes the gradient along ``dim``: a reshape that flattens ``parts``
    rows into ``dim`` (its backward unflattens the gradient, which a
    product may hand back sharded over more ways than there are rows; the
    forward's ``whole_dim`` gathers only the forward operand), or a
    product that folds ``dim`` into the one before it.  A plain tensor,
    or one that records no gradient, passes unchanged."""
    return _relaid(t, _same, lambda g: whole_dim(g, dim, parts))


def grad_replicated(t, j: int):
    """``t`` itself, whose gradient is made Replicate on mesh dimension
    ``j`` on its way back (a split there gathered, a Partial sum
    reduced).  Placed on the output of a row-split product whose input
    holds each rank's own channels: DTensor may hand that output a
    gradient split by batch over the model axis too, and the product's
    backward then gathers its weight and runs every step before it with
    all the channels on the rank's share of the batch (on ranks past the
    batch's end, none).  Replicate there, the gradient meets each rank's
    own channels, as Megatron's and GSPMD's backward keep it.  A plain
    tensor, or one that records no gradient, passes unchanged."""

    def bwd(g):
        pl = list(g.placements)
        if isinstance(pl[j], Replicate):
            return g
        pl[j] = Replicate()
        return g.redistribute(g.device_mesh, pl)

    return _relaid(t, _same, bwd)


def grad_like(t):
    """``t`` itself, whose gradient is laid out as ``t`` is (a Partial
    placement of ``t`` taken as Replicate) on its way back.  Placed on the
    LM head's logits, which the loss hands a gradient laid out as the
    labels (under sequence parallelism split on the sequence; the head's
    backward would gather it, and every model rank would compute the
    whole vocabulary's weight gradient), and on the embedding's rows,
    whose gradient may come back a Partial sum (``common.lookup``).  A
    plain tensor, or one that records no gradient, passes unchanged."""
    if not isinstance(t, DTensor):
        return t
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in t.placements)

    def bwd(g):
        if tuple(g.placements) == pl:
            return g
        return g.redistribute(g.device_mesh, pl)

    return _relaid(t, _same, bwd)


def own_rows(x, w):
    """The ``model`` mesh dimension over which ``x @ w`` runs on each
    rank's own rows (``on_own_rows``), or None.  ``x`` is a 3-D DTensor
    (batch, rows, d) with no Partial sum, split on its rows there or
    replicated there with rows that the model axis divides; ``w`` is a
    2-D DTensor whose columns no mesh dimension splits: the LM head over
    a vocabulary that the model axis does not divide, which the rules
    leave whole (internvl2-2b's 92,553 columns)."""
    m = _model_axis(x)
    if (m is None or m[1] == 1 or x.ndim != 3 or not isinstance(w, DTensor)
            or w.ndim != 2):
        return None
    j, ways = m
    if any(isinstance(p, Partial) for p in x.placements) or any(
            isinstance(p, Shard) and p.dim == 1 for p in w.placements):
        return None
    on_rows = [isinstance(p, Shard) and p.dim == 1 for p in x.placements]
    if on_rows[j] or (isinstance(x.placements[j], Replicate)
                      and not any(on_rows) and x.shape[1] % ways == 0):
        return j
    return None


def on_own_rows(fn, x, w, j: int):
    """``fn(x, w)``, a product of ``x``'s rows with ``w`` (``own_rows``),
    run on each rank's own rows: ``x`` split on its dimension 1 over mesh
    dimension ``j`` (a replicated ``x`` sliced locally, with no
    collective), ``w`` read whole (``whole_local``) and ``fn`` run on the
    local tensors, its result laid out as ``x``.  ``x``'s gradient comes
    back split as its rows; ``w``'s is each rank's ``x_localᵀ @
    g_local``, a Partial sum over every mesh dimension that splits
    ``x``, reduced into ``w``'s layout on the way back, as the other
    weight gradients are.  For the LM head whose columns the model axis
    does not split: DTensor's product (``common.matmul`` gathers ``x``'s
    rows first) ran every row's logits, forward and both gradients, on
    every model rank, where the reference's GSPMD runs them on each
    rank's own sequence rows."""
    x = split_locally(x, 1, j)
    pl = tuple(x.placements)
    split = tuple(k for k, p in enumerate(pl) if isinstance(p, Shard))
    out = fn(x.to_local(grad_placements=pl), whole_local(w, partial=split))
    shape = tuple(x.shape[:2]) + tuple(out.shape[2:])
    return DTensor.from_local(out, x.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous(shape))


def splits_rows(t) -> bool:
    """Whether ``t`` is a 3-D DTensor (batch, rows, columns) split on its
    rows over some mesh dimension, whole on its columns and holding no
    Partial sum: the logits of ``on_own_rows``."""
    if not isinstance(t, DTensor) or t.ndim != 3:
        return False
    pl = t.placements
    return (any(isinstance(p, Shard) and p.dim == 1 for p in pl)
            and not any(isinstance(p, Partial) or
                        (isinstance(p, Shard) and p.dim == 2) for p in pl))


def _contiguous(shape) -> tuple:
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def whole_local(t, keep=(), partial=()):
    """This rank's local tensor of DTensor ``t``, made whole (gathered, a
    Partial sum reduced) on every mesh dimension but those in ``keep``,
    where its split stays (the rank's own slice).  Its gradient goes back
    as a Partial sum over the mesh dimensions ``partial``, Replicate on
    the others (a split kept as it is), and is reduced into ``t``'s
    layout on the way back: a reduce-scatter onto a split, an all-reduce
    onto a replicated dimension.  For a tensor read whole by a function
    whose ranks each use another part of it (the MoE's tokens, gates and
    router): each rank's gradient is its share.  DTensor's own gather
    takes the gradient as Replicate, each rank's share as the whole, and
    the other ranks' shares are dropped.  A plain tensor passes
    unchanged."""
    if not isinstance(t, DTensor):
        return t
    pl = [p if j in keep else Replicate() for j, p in enumerate(t.placements)]
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return t.to_local(grad_placements=tuple(
        p if j in keep else Partial() if j in partial else Replicate()
        for j, p in enumerate(pl)))


def chunk_of(mesh, dims, size: int) -> tuple:
    """(start, stop) of this rank's chunk of ``size`` rows split over the
    mesh dimensions ``dims``, flattened in mesh order, by DTensor's chunk
    rule: ceil(size / ways) rows a rank, the last ranks fewer or none
    where the ways do not divide ``size`` (the MoE's capacity slots over
    the data ways: 15 over 16 in ``decode_32k``)."""
    idx, ways = 0, 1
    coord = mesh.get_coordinate()
    for j in dims:
        idx = idx * mesh.size(j) + coord[j]
        ways *= mesh.size(j)
    step = -(-size // ways)
    start = min(idx * step, size)
    return start, min(start + step, size)


def _split_names(ts, dims, sizes, mesh, uneven=()) -> list:
    """Per mesh dimension, the logical dimension (a key of ``sizes``) that
    it splits in every tensor of ``ts`` that has it, or None (all
    replicated there); see ``on_local_shards``."""
    names, ways = [], {n: 1 for n in sizes}
    for j in range(mesh.ndim):
        pl = [t.placements[j] for t in ts]
        seen = set()
        for t, d, p in zip(ts, dims, pl):
            if isinstance(p, Shard):
                by_dim = {v: n for n, v in d.items()}
                seen.add(by_dim.get(p.dim % t.ndim, "other"))
            elif isinstance(p, Partial):
                seen.add("partial")
        if seen == {"partial"} and all(isinstance(p, Partial) for p in pl):
            # DTensor reduce-scatters Partial operands onto the first
            # logical dimension that splits evenly
            choice = list(sizes)
        elif len(seen) == 1 and "other" not in seen and "partial" not in seen:
            choice = list(seen)
        else:
            choice = []
        # a split the operands already hold may be uneven (DTensor's chunk
        # rule) where it is the only split of its dimension
        n = next((n for n in choice
                  if sizes[n] % (ways[n] * mesh.size(j)) == 0
                  or (n in uneven and n in seen and ways[n] == 1)), None)
        if n is not None:
            ways[n] *= mesh.size(j)
        names.append(n)
    return names


def _placed(names, d) -> tuple:
    return tuple(Shard(d[n]) if n in d else Replicate() for n in names)


def _ways(mesh, names, name) -> int:
    """How many ways the mesh dimensions ``names`` gives split ``name``."""
    ways = 1
    for j, n in enumerate(names):
        if n == name:
            ways *= mesh.size(j)
    return ways


def _offset(mesh, names, name, size) -> int:
    """This rank's first index along logical dimension ``name`` (of
    ``size``), split over the mesh dimensions ``names`` gives it, in mesh
    order, by DTensor's chunk rule: ceil(size / ways) a rank, the last
    ranks holding fewer or none (an uneven split has one mesh dimension).
    The rank's count is its local shard's length."""
    idx = 0
    coord = mesh.get_coordinate()
    for j, n in enumerate(names):
        if n == name:
            idx = idx * mesh.size(j) + coord[j]
    return min(idx * -(-size // _ways(mesh, names, name)), size)


def _laid_out(t, pl):
    """DTensor ``t`` on placements ``pl``: a gather by DTensor's
    redistribute (the gradient split again as ``t`` was, as ``whole_dim``
    does), then a split or a Partial sum reduced with the gradient handed
    back as it comes (as DTensor's operators, which did these inside
    each operator, hand it back)."""
    mesh, cur = t.device_mesh, tuple(t.placements)
    gathered_ = tuple(Replicate() if isinstance(c, Shard)
                      and isinstance(p, Replicate) else c
                      for c, p in zip(cur, pl))
    if gathered_ != cur:
        t = t.redistribute(mesh, gathered_)
    if gathered_ != pl:
        t = _relaid(t, lambda x: x.redistribute(mesh, pl), _same)
    return t


def on_local_shards(fn, ts, dims, sizes, out_dims, offsets=(), uneven=(),
                    **kw):
    """``fn(*ts, **kw)`` run on each rank's local shards, for a function of
    many small operators (a loop over chunks) that DTensor would otherwise
    lay out operator by operator.

    ``dims[i]`` maps logical dimension names (the keys of ``sizes``, their
    global lengths, e.g. ``{"batch": B, "heads": nkv}``) to tensor i's
    dimensions; ``fn`` must be independent along each of them (a split
    one runs rank by rank), and ``out_dims`` does the same for ``fn``'s
    outputs (a dict for one output, a tuple of dicts for several).  Each
    mesh dimension keeps splitting one logical dimension where the
    operands already agree on it (a replicated operand is split locally,
    with no communication), a Partial sum over it is reduce-scattered
    onto the first logical dimension that it splits evenly, as DTensor's
    own choice for such products is, and anything else (a split of a
    dimension ``fn`` does not take apart, as a sequence that ``fn``
    chunks and masks by its global positions, or operands that disagree)
    is gathered once.  A name in ``uneven`` may stay split unevenly
    (DTensor's chunk rule) over the one mesh dimension that splits it;
    ``fn`` then gets local shards of unequal lengths, some empty.  The
    operands are then redistributed once (``_laid_out``), and ``fn`` runs
    on the local shards, whose results become DTensors of the global
    shape.  ``ts`` may hold None (an absent operand).  For each name in
    ``offsets`` ``fn`` receives the keyword ``<name>0``, the rank's first
    index along it (0 where it is not split).  Plain tensors call ``fn``
    directly."""
    if not any(isinstance(t, DTensor) for t in ts):
        return fn(*ts, **kw, **{n + "0": 0 for n in offsets})
    mesh = next(t.device_mesh for t in ts if isinstance(t, DTensor))
    ts = [t if t is None or isinstance(t, DTensor) else
          DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False) for t in ts]
    live = [(t, d) for t, d in zip(ts, dims) if t is not None]
    names = _split_names([t for t, _ in live], [d for _, d in live], sizes,
                         mesh, uneven)
    kw.update({n + "0": _offset(mesh, names, n, sizes[n]) for n in offsets})
    local = []
    for t, d in zip(ts, dims):
        if t is not None:
            pl = _placed(names, d)
            # an operand whole on a mesh dimension that splits the others
            # meets every rank's share: its gradient is their Partial sum
            t = _laid_out(t, pl).to_local(grad_placements=tuple(
                Partial() if n is not None and n not in d else p
                for n, p in zip(names, pl)))
        local.append(t.wait() if isinstance(t, AsyncCollectiveTensor) else t)
    out = fn(*local, **kw)
    uneven_names = {n for n in uneven
                    if sizes[n] % _ways(mesh, names, n)}

    def dist(o, d):
        shape = stride = None
        if any(n in uneven_names for n in d):
            # from_local assumes even shards: the global shape given
            shape = list(o.shape)
            for n in set(names) & set(d):
                shape[d[n] % o.ndim] = sizes[n]
            shape, stride = torch.Size(shape), _contiguous(shape)
        return DTensor.from_local(o, mesh, _placed(names, d),
                                  run_check=False, shape=shape, stride=stride)

    if isinstance(out_dims, dict):
        return dist(out, out_dims)
    return tuple(dist(o, d) for o, d in zip(out, out_dims))


def _model_axis(t):
    """(index, size) of the ``model`` mesh axis of DTensor ``t``, or None
    (a plain tensor, a mesh without one)."""
    if not isinstance(t, DTensor):
        return None
    names = list(mesh_shape(t.device_mesh))
    if "model" not in names:
        return None
    j = names.index("model")
    return j, t.device_mesh.size(j)


def _model_dim(t, groups: int):
    """The index of the ``model`` mesh axis of DTensor ``t`` where that
    axis has more than one rank and does not divide ``groups``, else
    None."""
    m = _model_axis(t)
    return m[0] if m is not None and m[1] > 1 and groups % m[1] else None


def model_divides(t, n: int):
    """The index of the ``model`` mesh axis of DTensor ``t`` where that
    axis has more than one rank and divides ``n`` (each rank can take
    whole n / model of them), else None."""
    m = _model_axis(t)
    return m[0] if m is not None and m[1] > 1 and n % m[1] == 0 else None


def split_locally(t, dim: int, j: int):
    """DTensor ``t`` with tensor dimension ``dim`` split over mesh
    dimension ``j``, its other placements kept.  A ``t`` replicated there
    is sliced locally, with no collective (the rank's own columns of a
    replicated weight)."""
    pl = list(t.placements)
    pl[j] = Shard(dim % t.ndim)
    if tuple(pl) == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def split_as_rows(t, w):
    """DTensor ``t`` with its last dimension split over each mesh
    dimension that splits the rows of the 2-D DTensor ``w`` and
    replicates ``t``: a local slice, with no collective.  For ``t @ w``:
    DTensor's product takes the same columns of ``t`` in the forward, but
    a ``t`` left whole meets the output's gradient whole in the backward,
    and every rank computes the gradient of all of ``w``'s rows.  Anything
    else passes unchanged."""
    if not (isinstance(t, DTensor) and isinstance(w, DTensor)) or w.ndim != 2:
        return t
    for j, p in enumerate(w.placements):
        if (isinstance(p, Shard) and p.dim == 0
                and isinstance(t.placements[j], Replicate)):
            t = split_locally(t, -1, j)
    return t


def split_q_heads(t, dim: int, groups: int):
    """(``t``, True) with its query-head dimension ``dim`` split over the
    ``model`` mesh axis where that axis cannot split whole groups of the
    ``groups`` kv heads, as the reference shards q on heads and replicates
    k/v (GSPMD pads an uneven head count; here DTensor's chunk rule gives
    a rank ceil(heads / model) heads and the last ranks fewer or none).
    One already split there keeps its split; a replicated ``t`` is sliced
    locally (``own_heads``).  (``t``, False) otherwise: a plain tensor, a
    model axis of 1 or one that divides ``groups``, or ``t`` laid out
    otherwise there (a Partial sum, another split dimension)."""
    j = _model_dim(t, groups)
    if j is None:
        return t, False
    dim %= t.ndim
    p = t.placements[j]
    if isinstance(p, Shard) and p.dim == dim:
        return t, True
    if not isinstance(p, Replicate):
        return t, False
    return own_heads(t, dim, j), True


def own_heads(t, dim: int, j: int):
    """Replicated DTensor ``t`` split on dimension ``dim`` over mesh
    dimension ``j`` by DTensor's chunk rule (``chunk_of``), a local slice
    with no collective, whose gradient goes back to ``t`` as a Partial sum
    over ``j``: each rank's share, zero outside its own slice (q's heads
    in a train step, each rank's attention on its own heads).  DTensor's
    redistribute would gather the slices' gradients instead."""
    mesh = t.device_mesh
    start, stop = chunk_of(mesh, (j,), t.shape[dim])
    local = whole_local(t, keep=[i for i in range(mesh.ndim) if i != j],
                        partial=(j,))
    pl = list(t.placements)
    pl[j] = Shard(dim)
    return DTensor.from_local(local.narrow(dim, start, stop - start), mesh,
                              pl, run_check=False, shape=t.shape,
                              stride=_contiguous(t.shape))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of matching trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
