"""AdamW, learning-rate schedules and global-norm clipping (the port of
``repro/train/optimizer.py``).

The optimizer state is a tree congruent with the parameter tree: f32
first and second moments and an int32 step.  :func:`adamw_update` updates
the parameters and the moments in place, a flat slice of at most
``CHUNK`` elements at a time, so the only memory it adds is a few slices'
temporaries (a full-width stacked leaf is 3.6 GB in f32, and one extra copy
of every leaf would be the whole model again).  The arithmetic is the
reference's, operation for operation, in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, NamedTuple

import torch

PyTree = Any

#: the most elements one pass of the update touches at once (64 MB of f32)
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    schedule: str = "cosine"  # cosine | linear | constant


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: PyTree
    nu: PyTree


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the tensors of ``tree`` (nested dicts, lists and tuples)
    and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def lr_at(cfg: OptimizerConfig, step: torch.Tensor | int) -> torch.Tensor:
    """Warmup then decay, as an f32 0-d tensor on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac)
        )
    elif cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    elif cfg.schedule == "constant":
        decay = torch.ones_like(frac)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return cfg.learning_rate * warm * decay


def init_opt_state(params: PyTree) -> AdamWState:
    """Zero f32 moments congruent with ``params`` and a zero int32 step, on
    the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = next(tree_leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _param_grads(grads: PyTree, params: PyTree) -> Iterator:
    """The gradient of each parameter leaf, in the parameters' order: a
    tensor, or the list of a stacked leaf's per-layer gradients."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _param_grads(grads[k], v)
    else:
        yield grads


def _slices(p: torch.Tensor, g, m: torch.Tensor, v: torch.Tensor):
    """Aligned flat views of at most ``CHUNK`` elements of a parameter, its
    gradient and its moments.  A gradient may be the list of the
    parameter's per-layer slices (its leading axis), as
    ``train.step`` differentiates a stacked leaf."""
    if isinstance(g, (list, tuple)):
        for i, gi in enumerate(g):
            yield from _slices(p[i], gi, m[i], v[i])
        return
    flat = [t.view(-1) for t in (p, g, m, v)]
    for s in range(0, flat[0].numel(), CHUNK):
        yield (t[s : s + CHUNK] for t in flat)


def adamw_update(
    cfg: OptimizerConfig,
    params: PyTree,
    grads: PyTree,
    state: AdamWState,
) -> tuple[PyTree, AdamWState, dict[str, torch.Tensor]]:
    """One AdamW step (global-norm clipping, bias-corrected moments,
    decoupled weight decay), written into ``params`` and the moments in
    place; returns (params, the state with the step advanced, metrics
    ``lr`` and ``grad_norm``)."""
    with torch.no_grad():
        grad_norm = global_norm(grads)
        scale = _clip_scale(grad_norm, cfg.grad_clip_norm)
        step = state.step + 1
        lr = lr_at(cfg, state.step)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        for p, g, m, v in zip(tree_leaves(params), _param_grads(grads, params),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            for ps, gs, ms, vs in _slices(p, g, m, v):
                gs = gs.float() * scale
                ms.mul_(b1).add_((1 - b1) * gs)
                vs.mul_(b2).add_((1 - b2) * gs.square())
                delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
                delta = delta + cfg.weight_decay * ps.float()
                ps.copy_(ps.float() - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
        "lr": lr, "grad_norm": grad_norm}
