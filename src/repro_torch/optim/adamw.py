"""AdamW with global-norm gradient clipping and LR schedules (port of
``repro.optim.adamw``).

Plain tensor code, not ``torch.optim.AdamW``: the reference clips by the
global norm with ``min(1, max / (norm + 1e-9))``, decays every leaf but
norms, biases and the SSM's scalars (``_is_decayed``) and adds the decay
to the Adam step before the learning rate, which ``torch.optim`` does
not.  The optimizer state has the parameters' tree structure, in fp32.
Like the reference, ``adamw_update`` is functional: it returns new
parameter and state trees and leaves its arguments as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models import partitioning
from repro_torch.tree import leaves, map_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | constant | linear


class OptState(NamedTuple):
    step: torch.Tensor             # () int32
    mu: dict                       # first moment  (fp32)
    nu: dict                       # second moment (fp32)


def opt_state_axes(param_axes) -> OptState:
    """The optimizer state's logical axes: each moment those of its
    parameter (so a launcher shards it alike), the step counter none."""
    return OptState(step=(), mu=param_axes, nu=param_axes)


def init_opt_state(params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=zeros, nu=tree_map(torch.clone, zeros))


def abstract_opt_state(params) -> OptState:
    """``init_opt_state``'s shapes and dtypes for ``params`` (any tensors
    of the right shapes, such as ``models.model.abstract_params``'), as
    tensors on the meta device: nothing allocated."""
    meta = torch.device("meta")
    return OptState(
        step=torch.empty((), dtype=torch.int32, device=meta),
        mu=tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                          device=meta), params),
        nu=tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                          device=meta), params))


def learning_rate(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """fp32 learning rate at ``step``: linear warmup, then the schedule."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.learning_rate * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "linear":
        decay = 1.0 - frac
    else:  # cosine
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * decay


def global_norm(tree, specs=None) -> torch.Tensor:
    """The l2 norm over every leaf.  Given ``specs`` (the tree's specs
    on the active mesh, ``models.partitioning``), ``tree`` holds this
    rank's blocks: each leaf's squares are summed over its block, a leaf
    whole over a mesh axis counts only at coordinate 0 of that axis, and
    the sum is all-reduced over the world, so the norm is the whole
    tree's on every rank.  A leaf of a ``partitioning.IndexSpec`` counts
    on every model rank the positions no lower rank holds (Mamba2's B and
    C columns once), or held whole, only at model coordinate 0."""
    flat = leaves(tree)
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in flat]
    mesh = partitioning.active_mesh() if specs is not None else None
    if mesh is None:
        return torch.sqrt(torch.stack(sq).sum())
    mine = []
    for x, s, spec in zip(flat, sq, partitioning.spec_leaves(specs, tree)):
        named = set()
        for entry in spec:
            named.update((entry,) if isinstance(entry, str)
                         else entry or ())
        if isinstance(spec, partitioning.IndexSpec):
            if spec.index is None:
                named.discard("model")
            else:
                named.add("model")
                own = spec.own(mesh.coord("model"))
                if own is not None:
                    s = torch.sum(torch.square(x.index_select(
                        spec.dim, own.to(x.device)).to(torch.float32)))
        if all(mesh.coord(a) == 0 for a in mesh.axis_names
               if a not in named):
            mine.append(s)
    total = (torch.stack(mine).sum() if mine
             else torch.zeros((), dtype=torch.float32, device=sq[0].device))
    world = mesh.group("world")
    if world is not None:
        total = world.all_reduce(total)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads in fp32 scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


_NO_DECAY = {"scale", "bias", "a_log", "d_skip", "dt_bias", "gate_norm",
             "q_norm", "k_norm", "conv_b"}


def _is_decayed(path) -> bool:
    """No weight decay on norms / biases / scalars: a path none of whose
    dict keys or list indices is in the reference's skip set."""
    names = {value for kind, value in path if kind in ("key", "idx")}
    return not (names & _NO_DECAY)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState,
                 specs=None):
    """One AdamW step.  Returns (new_params, new_state, {"lr",
    "grad_norm"}); the bias corrections are fp32, and each updated
    parameter is cast back to its leaf's dtype.  On a mesh, ``specs``
    (the parameters') makes the clipping norm the whole tree's
    (``global_norm``); the update itself is elementwise, on blocks.

    The reference's formulas, leaf by leaf: each leaf's clipped gradient
    lives only while its leaf is updated, and the new moments and the
    update are built in place on fresh tensors, so an update makes about
    13 passes over a leaf rather than 17 and never holds a clipped copy
    of the whole gradient tree."""
    grad_norm = global_norm(grads, specs)
    scale = torch.clamp(cfg.grad_clip_norm / (grad_norm + 1e-9), max=1.0)
    step = state.step + 1
    lr = learning_rate(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    updated = {}

    def upd(path, p, g, m, v):
        g = g.to(torch.float32) * scale
        m = (m * b1).add_(g, alpha=1 - b1)
        v = (v * b2).addcmul_(g, g, value=1 - b2)
        del g
        p32 = p.to(torch.float32)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if _is_decayed(path):
            delta.add_(p32, alpha=cfg.weight_decay)
        updated[path] = ((p32 - delta.mul_(lr)).to(p.dtype), m, v)

    map_with_path(upd, params, grads, state.mu, state.nu)
    new_p, mu, nu = (map_with_path(lambda path, _, i=i: updated[path][i],
                                   params) for i in range(3))
    return new_p, OptState(step=step, mu=mu, nu=nu), {
        "lr": lr, "grad_norm": grad_norm}
