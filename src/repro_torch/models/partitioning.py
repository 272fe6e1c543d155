"""The serving device mesh over ``torch.distributed`` ranks (port of
``repro.models.partitioning``).

The reference names parameter and activation axes logically ("batch",
"heads", "ffn", ...) and maps them to the axes of a JAX device mesh with
``DEFAULT_RULES``; GSPMD then inserts the collectives.  Here a mesh is
a grid of ``torch.distributed`` ranks laid out row-major over named axes
(``Mesh``), with one process group per axis: ``resolve_spec`` maps
logical axes to mesh axes by the same rules, ``launch.shardings``
slices a whole parameter tree to this rank's block, and the model code
issues the collectives itself where a leaf is sharded (the "model" axis:
``ModelGroup``, whose collectives carry their backward: Megatron's
conjugate pairs).  A mesh also has an "fsdp" group, the ranks that share
every coordinate but the batch axes ("pod", "data"), over which a
training step gathers the FSDP-sharded weights and reduces their
gradients, and serving gathers its blocks of the coded streams
(``batch_group``, ``batch_block``), and a "world" group for the global
gradient norm.
``mesh_context`` makes a mesh the active one; ``active_group()``
returns its "worker" group, the serving code's choice between the
worker-sharded tail and the one-rank path.  ``WorkerGroup`` wraps one
group's collectives and counts the bytes each moves, by op, as the
reference's ``hlo_analysis.collective_bytes`` counts them in the
compiled program.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import ref
from repro_torch.tree import flatten_with_path

# Default logical -> physical rules of the production meshes (DESIGN.md
# §7), the reference's word for word.  Entries may be a single mesh
# axis, a tuple of axes, or None (replicated).  "batch"/"fsdp" pick up
# the "pod" axis automatically when it exists.
DEFAULT_RULES = {
    # The "worker" axis only exists on serving meshes (launch/mesh.py
    # make_worker_mesh): coded streams laid out worker-major shard over it
    # so each mesh rank IS an ApproxIFER worker.  Absent axes are dropped
    # by resolve_spec, so train meshes are unaffected.
    "batch": ("worker", "pod", "data"),  # coded-stream / batch axis
    "seq": None,                    # sequence (context parallel = perf lever)
    "d_model": None,                # residual stream stays replicated
    "heads": "model",               # attention q heads
    "kv_heads": "model",            # only applied when divisible (see below)
    "kv_seq": None,                 # cache length (sharded when kv small)
    "head_dim": None,
    "ffn": "model",                 # MLP hidden
    "experts": "model",             # MoE expert dim (when divisible)
    "expert_ffn": "model",          # per-expert hidden (when experts aren't)
    "vocab": "model",               # embedding / lm-head vocab dim
    "fsdp": ("pod", "data"),        # weight-sharding axis
    "layers": None,                 # stacked-scan layer axis
    "conv": None,
    "state": None,
    # MoE dispatch groups are a reshape of the token/batch axis — they MUST
    # shard over the batch axes.  (A None rule here forces replication via
    # the explicit constraint: we measured 18 TB/device of all-gathers on
    # grok-1 train before this fix — EXPERIMENTS.md §Perf grok iteration 1.)
    "groups": ("pod", "data"),
    "capacity": None,
    "workers": "worker",            # coded-stream axis inside a group
    # flattened feature axis of the Berrut encode/decode contraction: the
    # group axis is tiny (G ~ 4), so the feature axis carries ALL the
    # parallelism during coding (§Perf iteration 5)
    "coded_flat": ("pod", "data", "model"),
}


# The logical axes that may shard unevenly (padded blocks).  Empty, as
# in the reference; its only reader will be the dry run's uneven-heads
# option (ROADMAP A11).  ``resolve_spec`` always requires divisibility:
# ``launch.shardings.local_shard`` has no padded block.
UNEVEN_OK: set = set()

# The single-tensor collectives, by the name this torch gives them: 2.13
# renamed them (``*_single``; the old names warn), older releases have
# only the old names.  Same signatures.
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class WorkerGroup:
    """A ``torch.distributed`` process group as one mesh axis: on the
    "worker" axis rank r of W owns the r-th contiguous block of the
    worker-major streams; over the batch axes ("fsdp") rank r holds the
    r-th sub-block of its worker's block (``batch_block``).

    ``bytes`` accumulates each collective's per-rank traffic under the
    ring algorithm, with B the output bytes of the op and n the group
    size (the reference's accounting): all-gather B (n-1)/n,
    reduce-scatter B (n-1) (B the scattered output), all-reduce
    2 B (n-1)/n.  A one-rank group moves nothing and counts nothing.
    """

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not dist.is_initialized():
            raise RuntimeError("a worker group needs torch.distributed "
                               "initialised (init_process_group)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.bytes: Dict[str, float] = collections.defaultdict(float)

    def _count(self, op: str, out: torch.Tensor, factor: float) -> None:
        if self.size > 1:
            self.bytes[op] += out.numel() * out.element_size() * factor

    def collective_bytes(self) -> Dict[str, float]:
        """{op: bytes} moved so far, plus "total"."""
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        return out

    def reset_bytes(self) -> None:
        self.bytes.clear()

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * xm.shape[0],) + xm.shape[1:],
                          dtype=x.dtype, device=x.device)
        _ALL_GATHER(out, xm, group=self.group)
        self._count("all-gather", out, (self.size - 1) / self.size)
        return out.movedim(0, dim % x.dim())

    def reduce_scatter(self, x: torch.Tensor, dim: int = -1
                       ) -> torch.Tensor:
        """The sum over ranks of ``x``, of which rank r keeps the r-th of
        W equal blocks of axis ``dim`` (the last by default)."""
        w = self.size
        dim %= x.dim()
        v = x.shape[dim]
        if v % w:
            raise ValueError(f"cannot scatter an axis of {v} over {w} "
                             f"ranks")
        if dim == x.dim() - 1:
            blocks = x.unflatten(-1, (w, v // w)).movedim(-2, 0)
            blocks = blocks.contiguous().flatten(0, 1)
        else:
            blocks = x.movedim(dim, 0).contiguous()
        out = torch.empty((blocks.shape[0] // w,) + blocks.shape[1:],
                          dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER(out, blocks, group=self.group)
        self._count("reduce-scatter", out, w - 1)
        if dim == x.dim() - 1:
            return out.reshape(x.shape[:-1] + (v // w,))
        return out.movedim(0, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x`` (a new tensor)."""
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        self._count("all-reduce", out, 2.0 * (self.size - 1) / self.size)
        return out


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the gradient passes through unchanged (each
    rank's loss reads the whole sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return WorkerGroup.all_reduce(group, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Enter(torch.autograd.Function):
    """The identity; the gradient is summed over the group (each rank's
    gradient of a replicated input is its part's share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return WorkerGroup.all_reduce(ctx.group, grad), None


class _AllGather(torch.autograd.Function):
    """Every rank's block joined along ``dim``; the gradient keeps this
    rank's slice (every rank reads the same whole from the same loss)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n, ctx.rank = dim % x.dim(), x.shape[dim], group.rank
        return WorkerGroup.all_gather(group, x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class ModelGroup(WorkerGroup):
    """The "model" axis (tensor parallelism): rank r holds the r-th block
    of every parameter whose spec names the axis (its positions of an
    ``IndexSpec``'s dimension).  The forward sums
    partial products (``all_reduce``), joins vocabulary blocks
    (``all_gather``) and marks where a replicated activation or leaf
    enters a rank's block of the work (``enter``).  These three carry
    their backward, Megatron's conjugate pairs: ``all_reduce`` passes the
    gradient through, ``enter`` all-reduces it, ``all_gather`` keeps this
    rank's slice.  Every rank of the axis computes the same loss, so the
    gradient it keeps of a block is the whole gradient of that block."""

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return _AllGather.apply(x, self, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _AllReduce.apply(x, self)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, whose gradient is all-reduced over the axis."""
        return _Enter.apply(x, self)

    def merge_ring_blocks(self, out: torch.Tensor, lse: torch.Tensor,
                          scatter: bool) -> torch.Tensor:
        """Join the decode attention of the ranks' blocks of one ring (the
        cache length split over this axis): ``out`` (B, H, D) fp32 and
        ``lse`` (B, H) fp32, the block form over this rank's slots for
        every q-head, -> sum_r w_r out_r with ``ref.merge_weights_ref``'s
        weights (each rank's share of a row's softmax), fp32.  The lses
        are all-gathered and the weighted outputs summed over the axis:
        with ``scatter`` by a reduce-scatter over the heads, of which rank
        r keeps the r-th block of H / M (its q-heads), else by an
        all-reduce (q-heads whole on every rank).  A row that sees no key
        on any rank gives exact zeros."""
        b, h, d = out.shape
        if torch.is_grad_enabled() and out.requires_grad:
            raise RuntimeError("merge_ring_blocks has no backward: it "
                               "joins the decode attention of the ranks' "
                               "ring blocks, which only serving runs")
        w = ref.merge_weights_ref(self.all_gather(lse[None], 0))[self.rank]
        part = (out * w[..., None]).reshape(b, h * d)
        if scatter:
            return self.reduce_scatter(part).reshape(b, h // self.size, d)
        return self.all_reduce(part).reshape(b, h, d)


# The batch axes: the reference's "fsdp" rule shards weights over them
# jointly, row-major (``DEFAULT_RULES``).
BATCH_AXES = ("pod", "data")


class Mesh:
    """Ranks laid out row-major over named axes, as ``jax.make_mesh``
    lays out devices: rank = sum of coordinate x stride, the last axis
    fastest.  ``groups`` holds this rank's process group of each axis
    above size 1 (a ``WorkerGroup``; the "model" axis's a
    ``ModelGroup``), and under "fsdp" and "world" the groups of the
    batch axes jointly and of every rank, above size 1.  Without groups
    a mesh is only a layout, which is all ``resolve_spec`` and
    ``padded_batch`` read (``axis_names`` and ``shape``, as the
    reference reads ``mesh.devices.shape``)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int = 0,
                 groups: Optional[Dict[str, WorkerGroup]] = None):
        if len(axis_names) != len(shape) or len(set(axis_names)) \
                != len(axis_names):
            raise ValueError(f"mesh axes {axis_names} vs shape {shape}")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)
        self.sizes = dict(zip(self.axis_names, self.shape))
        self.rank = rank
        coords, rest = {}, rank
        for name, n in reversed(list(self.sizes.items())):
            coords[name], rest = rest % n, rest // n
        self.coords = coords
        self.groups = dict(groups or {})

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.sizes.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Optional[WorkerGroup]:
        """This rank's group of ``axis`` ("fsdp" and "world" too): None
        at size 1."""
        return self.groups.get(axis)

    def fsdp_size(self) -> int:
        """The ranks of an FSDP group: the product of the batch axes."""
        return math.prod(self.size(a) for a in BATCH_AXES)

    def fsdp_index(self) -> int:
        """This rank's place in its FSDP group: its batch-axes
        coordinates read row-major, the block of an "fsdp"-sharded leaf
        (and of the batch's rows) that it holds."""
        idx = 0
        for a in BATCH_AXES:
            idx = idx * self.size(a) + self.coord(a)
        return idx

    def axis_bytes(self) -> Dict[str, float]:
        """{group: bytes} each group ("model", "fsdp", "world", ...) moved
        so far."""
        return {name: sum(group.bytes.values())
                for name, group in self.groups.items()}

    def collective_bytes(self) -> Dict[str, float]:
        """{op: bytes} every axis's group moved so far, plus "total"."""
        out: Dict[str, float] = collections.defaultdict(float)
        for group in self.groups.values():
            for op, b in group.bytes.items():
                out[op] += b
        out = dict(out)
        out["total"] = sum(out.values())
        return out

    def reset_bytes(self) -> None:
        for group in self.groups.values():
            group.reset_bytes()


def axis_ranks(axis_names: Sequence[str], shape: Sequence[int],
               axis: str) -> list:
    """The rank lists of ``axis``'s groups (every other coordinate fixed),
    in the order of those coordinates; each list in ``axis`` order."""
    return axes_ranks(axis_names, shape, [axis])


def axes_ranks(axis_names: Sequence[str], shape: Sequence[int],
               axes: Sequence[str]) -> list:
    """The rank lists of the groups over ``axes`` jointly (every other
    coordinate fixed), each in rank order, which is ``axes`` read
    row-major in the mesh's order."""
    others = [a for a in axis_names if a not in axes]
    groups: dict = {}
    for rank in range(math.prod(shape)):
        coords, rest = {}, rank
        for name, n in reversed(list(zip(axis_names, shape))):
            coords[name], rest = rest % n, rest // n
        groups.setdefault(tuple(coords[a] for a in others), []).append(rank)
    return sorted(groups.values())


def build_mesh(axis_names: Sequence[str], shape: Sequence[int]) -> Mesh:
    """A mesh over the default process group, whose world size must equal
    the product of ``shape``.  Every rank builds every axis's groups in
    the same order (``new_group`` is collective) on the default group's
    backend; an axis that spans the whole world uses the default group,
    an axis of size 1 gets none.  The "fsdp" group (the batch axes
    jointly) and the "world" group follow, where above one rank."""
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed before building a "
                           "mesh (init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {dict(zip(axis_names, shape))} needs "
            f"{math.prod(shape)} processes, the process group has {world}")
    rank = dist.get_rank()
    groups = {}
    batch = [a for a in BATCH_AXES if a in axis_names]
    fsdp = math.prod(n for a, n in zip(axis_names, shape) if a in batch)
    for axis, n in list(zip(axis_names, shape)) + [("fsdp", fsdp),
                                                    ("world", world)]:
        if n == 1:
            continue
        kind = ModelGroup if axis == "model" else WorkerGroup
        if n == world:
            groups[axis] = kind()
            continue
        for ranks in axes_ranks(axis_names, shape,
                                batch if axis == "fsdp" else [axis]):
            pg = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = kind(pg)
    return Mesh(axis_names, shape, rank, groups)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None


_CTX = _Ctx()


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    """Make ``mesh`` the active mesh (the reference's
    ``logical_sharding_context``)."""
    prev = _CTX.mesh
    _CTX.mesh = mesh
    try:
        yield mesh
    finally:
        _CTX.mesh = prev


# The worker-axis paths' name for ``mesh_context``.
worker_group_context = mesh_context


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``mesh_context`` (or None)."""
    return _CTX.mesh


def active_group() -> Optional[WorkerGroup]:
    """The active mesh's "worker" group (or None): the serving code's
    choice between the worker-sharded tail and the one-rank path, as
    ``active_mesh()`` is the reference's."""
    return None if _CTX.mesh is None else _CTX.mesh.group("worker")


def axis_size(axis: str) -> int:
    """The active mesh's size of ``axis`` (1 off any mesh)."""
    return 1 if _CTX.mesh is None else _CTX.mesh.size(axis)


def fsdp_group() -> Optional[WorkerGroup]:
    """The active mesh's FSDP group (the batch axes jointly), or None off
    any mesh and at one rank: a training step's loss is this rank's share
    of the loss summed over it."""
    return None if _CTX.mesh is None else _CTX.mesh.group("fsdp")


# Serving's name for the same group: the ranks that share a worker (and
# model) coordinate, over which the batch steps gather their blocks of
# the coded streams, in block order (``batch_block``).
batch_group = fsdp_group


def model_group() -> ModelGroup:
    """The active mesh's "model" group, which a sharded leaf needs."""
    group = None if _CTX.mesh is None else _CTX.mesh.group("model")
    if group is None:
        raise RuntimeError("a model-sharded parameter needs an active mesh "
                           "with a model axis (partitioning.mesh_context)")
    return group


def resolve_spec(mesh, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None,
                 rules: Optional[dict] = None) -> tuple:
    """Map a tuple of logical axis names to the per-dimension mesh axes of
    ``mesh`` (an entry is None, an axis name or a tuple of them: the
    reference's ``PartitionSpec`` entries).

    Axes whose size does not divide the mesh-axis product are replicated
    (e.g. kv_heads=8 on a 16-way "model" axis), and no mesh axis is used
    twice.
    """
    rules = rules or DEFAULT_RULES
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    spec, used = [], set()
    for i, name in enumerate(logical_axes):
        phys = rules.get(name) if name else None
        if phys is None:
            spec.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        phys = tuple(a for a in phys if a in sizes and a not in used)
        if not phys:
            spec.append(None)
            continue
        if shape is not None and \
                shape[i] % math.prod(sizes[a] for a in phys):
            spec.append(None)
            continue
        used.update(phys)
        spec.append(phys if len(phys) > 1 else phys[0])
    return tuple(spec)


def padded_batch(n: int) -> int:
    """Round a batch/coded-stream count up to the active mesh's product
    of the worker, pod and data axes (no-op off any mesh): a rank holds
    whole streams of an even share."""
    p = axis_size("worker") * axis_size("pod") * axis_size("data")
    return -(-n // p) * p


def batch_block(n: int, mesh: Optional[Mesh] = None) -> tuple:
    """(start, length) of this rank's block of ``n`` rows sharded by the
    "batch" rule (the reference's ``PartitionSpec`` of it): its
    coordinates over ("worker", "pod", "data") read row-major, worker
    outermost whatever the mesh's own axis order, block ``(w P + p) D +
    d`` of ``W P D`` equal blocks.  On ``mesh``, else the active one; off
    any mesh all ``n`` rows.  Raises where the axes do not divide
    ``n``."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return 0, n
    idx, blocks = 0, 1
    for a in DEFAULT_RULES["batch"]:
        idx = idx * mesh.size(a) + mesh.coord(a)
        blocks *= mesh.size(a)
    if n % blocks:
        raise ValueError(f"{n} rows do not split into {blocks} blocks over "
                         f"the batch axes {DEFAULT_RULES['batch']}")
    length = n // blocks
    return idx * length, length


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of axis names or Nones."""
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def _map_axes(fn, axes_tree, tree):
    """``fn(axes, leaf)`` over a logical-axes tree and the matching tree
    (dicts and lists)."""
    if is_axes(axes_tree):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, tree[k]) for k, v in axes_tree.items()}
    if hasattr(axes_tree, "_fields"):              # e.g. optim.OptState
        return type(axes_tree)(*(_map_axes(fn, a, t)
                                 for a, t in zip(axes_tree, tree)))
    return [_map_axes(fn, a, t) for a, t in zip(axes_tree, tree)]


def spec_leaves(specs, tree) -> list:
    """The spec of every leaf of ``tree`` (a tree of the structure of
    ``specs``, whose leaves are spec tuples), in ``tree.leaves`` order."""
    out = []
    for path, _ in flatten_with_path(tree):
        spec = specs
        for kind, key in path:
            spec = getattr(spec, key) if kind == "attr" else spec[key]
        out.append(spec)
    return out


class IndexSpec(tuple):
    """A spec (the reference's entries, and equal to them as a tuple)
    whose dimension ``dim`` a rank of the "model" axis holds by index
    rather than as the contiguous block the entry there names: rank r
    holds positions ``index[r]`` of the whole leaf along ``dim``, in that
    order (a position may be held by several ranks), or with ``index``
    None the whole dimension, whatever the entry says.  Mamba2's
    head-aligned layout (``models.mamba2.head_spec``) lies beneath the
    reference's spec this way; ``launch.shardings.local_shard`` and
    ``gather_leaf`` and ``optim.global_norm`` read it."""

    def __new__(cls, spec, dim: int, index: Optional[list]):
        out = super().__new__(cls, spec)
        out.dim, out.index = dim, index
        return out

    def own(self, rank: int) -> Optional[torch.Tensor]:
        """The positions of rank ``rank``'s block that no lower rank
        holds (None: all of them), so that a sum over the ranks' blocks
        counts each position of the whole leaf once."""
        if self.index is None or rank == 0:
            return None
        lower = torch.cat(self.index[:rank])
        return torch.nonzero(~torch.isin(self.index[rank], lower))[:, 0]


def fsdp_dim(spec: tuple) -> Optional[int]:
    """The dimension of a leaf that ``spec`` shards over the batch axes
    (the reference's "fsdp" rule: every batch axis of the mesh jointly,
    so the FSDP group's rank order is its block order), or None."""
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if set(axes) & set(BATCH_AXES):
            return dim
    return None


def param_sharding(mesh, logical_axes_tree, params_shapes,
                   rules: Optional[dict] = None):
    """The spec of every parameter: ``resolve_spec`` leaf by leaf.

    logical_axes_tree: tree of axis tuples matching the params'
    structure; params_shapes: the matching tree of tensors or shapes.
    """
    def one(axes, leaf):
        return resolve_spec(mesh, axes, tuple(getattr(leaf, "shape", leaf)),
                            rules)

    return _map_axes(one, logical_axes_tree, params_shapes)
