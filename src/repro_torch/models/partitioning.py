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
``ModelGroup``).  ``mesh_context`` makes a mesh the active one;
``active_group()`` returns its "worker" group, the serving code's choice
between the worker-sharded tail and the one-rank path.  ``WorkerGroup``
wraps one axis's collectives and counts the bytes each moves, by op, as
the reference's ``hlo_analysis.collective_bytes`` counts them in the
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
    worker-major streams, on the "data" axis the r-th block of the
    group-major ones.

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

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x``, of which rank r keeps the r-th of
        W equal blocks of the last axis."""
        w = self.size
        v = x.shape[-1]
        if v % w:
            raise ValueError(f"cannot scatter a last axis of {v} over "
                             f"{w} ranks")
        blocks = x.unflatten(-1, (w, v // w)).movedim(-2, 0).contiguous()
        out = torch.empty(blocks.shape[1:], dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER(out, blocks.flatten(0, 1), group=self.group)
        self._count("reduce-scatter", out, w - 1)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x`` (a new tensor)."""
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        self._count("all-reduce", out, 2.0 * (self.size - 1) / self.size)
        return out


class ModelGroup(WorkerGroup):
    """The "model" axis (tensor parallelism): rank r holds the r-th block
    of every parameter whose spec names the axis, and the forward sums
    partial products (``all_reduce``) and joins vocabulary blocks
    (``all_gather``) over it.  These collectives have no backward yet:
    under grad they raise on every device, as the serving kernels do on
    the card (training on a model axis is ROADMAP A9.2)."""

    @staticmethod
    def _refuse_grad(x: torch.Tensor) -> None:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                "a model-axis collective has no backward: run the "
                "tensor-parallel forward under torch.no_grad() (training "
                "on the model axis is ROADMAP A9.2)")

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        self._refuse_grad(x)
        return super().all_gather(x, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        self._refuse_grad(x)
        return super().all_reduce(x)

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
        self._refuse_grad(out)
        w = ref.merge_weights_ref(self.all_gather(lse[None], 0))[self.rank]
        part = (out * w[..., None]).reshape(b, h * d)
        if scatter:
            return self.reduce_scatter(part).reshape(b, h // self.size, d)
        return self.all_reduce(part).reshape(b, h, d)


class Mesh:
    """Ranks laid out row-major over named axes, as ``jax.make_mesh``
    lays out devices: rank = sum of coordinate x stride, the last axis
    fastest.  ``groups`` holds this rank's process group of each axis
    above size 1 (a ``WorkerGroup``; the "model" axis's a
    ``ModelGroup``).  Without groups a mesh is only a layout, which is
    all ``resolve_spec`` and ``padded_batch`` read (``axis_names`` and
    ``shape``, as the reference reads ``mesh.devices.shape``)."""

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
        """This rank's group of ``axis``: None at size 1."""
        return self.groups.get(axis)

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
    i = list(axis_names).index(axis)
    strides = [math.prod(shape[j + 1:]) for j in range(len(shape))]
    others = [j for j in range(len(shape)) if j != i]
    groups = []
    for idx in range(math.prod(shape[j] for j in others)):
        base, rest = 0, idx
        for j in reversed(others):
            base += (rest % shape[j]) * strides[j]
            rest //= shape[j]
        groups.append([base + c * strides[i] for c in range(shape[i])])
    return sorted(groups)


def build_mesh(axis_names: Sequence[str], shape: Sequence[int]) -> Mesh:
    """A mesh over the default process group, whose world size must equal
    the product of ``shape``.  Every rank builds every axis's groups in
    the same order (``new_group`` is collective) on the default group's
    backend; an axis that spans the whole world uses the default group,
    an axis of size 1 gets none."""
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
    for axis, n in zip(axis_names, shape):
        if n == 1:
            continue
        kind = ModelGroup if axis == "model" else WorkerGroup
        if n == world:
            groups[axis] = kind()
            continue
        for ranks in axis_ranks(axis_names, shape, axis):
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
    return [_map_axes(fn, a, t) for a, t in zip(axes_tree, tree)]


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
