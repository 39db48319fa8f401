"""The training step (the port of ``repro/train/step.py``): loss, gradients,
microbatches accumulated in f32, one AdamW update.

The gradient is taken with respect to the leaves of the parameter tree as
the model uses them: a stacked leaf (a layer axis first, as under
``layers``) is differentiated as the list of its per-layer slices, each a
view of the stacked tensor.  Every layer's gradient then lands in a tensor
of its own, and the optimizer writes each layer's update through its view,
so a step needs no stacked gradient beside the per-layer ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.params import STACKED
from repro_torch.train import loss as loss_lib
from repro_torch.train import optimizer as opt_lib

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt_lib.OptimizerConfig = opt_lib.OptimizerConfig()
    microbatches: int = 1
    z_loss_weight: float = 1e-4
    compute_dtype: torch.dtype = torch.bfloat16


def make_loss_fn(
    model: Any, cfg: ModelConfig, tcfg: TrainConfig
) -> Callable[[PyTree, dict], tuple[torch.Tensor, dict]]:
    """``loss_fn(params, batch) -> (total, metrics)``: the model's forward,
    a VLM's logits cut to the text positions, the cross-entropy against
    ``batch["labels"]`` over the padded vocab (so no id is masked, as in
    the reference), plus ``router_aux_weight`` times the MoE aux loss
    (reported as ``moe_aux``) where the config has experts."""

    def loss_fn(params: PyTree, batch: dict) -> tuple[torch.Tensor, dict]:
        logits, aux = model.forward(params, batch, dtype=tcfg.compute_dtype)
        if cfg.family == "vlm":
            logits = logits[:, cfg.n_vision_tokens :]
        total, metrics = loss_lib.cross_entropy(
            logits, batch["labels"], cfg.padded_vocab, tcfg.z_loss_weight
        )
        if cfg.n_experts:
            total = total + cfg.router_aux_weight * aux
            metrics["moe_aux"] = aux.detach()
        metrics["loss"] = total.detach()
        return total, metrics

    return loss_fn


def grad_leaves(params: PyTree) -> tuple[PyTree, list[torch.Tensor]]:
    """A tree like ``params`` whose leaves are fresh autograd leaves that
    share the parameters' storage (the leaves under ``STACKED`` as lists of
    per-layer slices), and those leaves in order."""
    leaves: list[torch.Tensor] = []

    def leaf(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    def walk(node, stacked: bool):
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        return [leaf(t) for t in node.detach().unbind(0)] if stacked else leaf(node)

    tree = {k: walk(v, k in STACKED) for k, v in params.items()}
    return tree, leaves


def _rebuild(tree: PyTree, values: Iterator[torch.Tensor]) -> PyTree:
    """``tree``'s structure (lists included) with its leaves taken from
    ``values`` in order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, list):
        return [next(values) for _ in tree]
    return next(values)


def loss_and_grads(
    loss_fn: Callable, params: PyTree, batch: dict
) -> tuple[torch.Tensor, dict, PyTree]:
    """(total, metrics, grads): ``grads`` congruent with ``params``, a
    stacked leaf's gradient as the list of its per-layer gradients."""
    view, leaves = grad_leaves(params)
    with torch.enable_grad():
        total, metrics = loss_fn(view, batch)
        grads = torch.autograd.grad(total, leaves, materialize_grads=True)
    return total.detach(), metrics, _rebuild(view, iter(grads))


def make_train_step(
    model: Any, cfg: ModelConfig, tcfg: TrainConfig
) -> Callable[[PyTree, opt_lib.AdamWState, dict], tuple[PyTree, Any, dict]]:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the parameters and the moments are updated in place.
    With ``tcfg.microbatches`` = M > 1 the batch's leading axis is split
    into M microbatches, whose gradients are summed in f32 as ``g / M`` in
    order (the first added to zero), and so are the metrics."""
    loss_fn = make_loss_fn(model, cfg, tcfg)
    m = tcfg.microbatches

    def train_step(params, opt_state, batch):
        if m > 1:
            micro = [{k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(m)]
            grads = metrics = None
            for mb in micro:
                _, met, g = loss_and_grads(loss_fn, params, mb)
                g = opt_lib.tree_map(lambda x: x.float() / m, g)
                met = {k: v / m for k, v in met.items()}
                if grads is None:
                    grads, metrics = g, met
                else:
                    opt_lib.tree_map(lambda a, x: a.add_(x), grads, g)
                    metrics = {k: metrics[k] + met[k] for k in metrics}
        else:
            _, metrics, grads = loss_and_grads(loss_fn, params, batch)
        params, opt_state, opt_metrics = opt_lib.adamw_update(
            tcfg.optimizer, params, grads, opt_state
        )
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
