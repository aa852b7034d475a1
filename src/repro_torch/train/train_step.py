"""Train and serve step factories (the JAX package's
``repro/train/train_step.py``).

The JAX step is a pure function under ``jax.jit``; the port's runs eagerly
and updates the state's tensors in place (``optimizer.adamw_update``),
returning a ``TrainState`` that holds them.

While a profiler is active a step records its spans (``repro_torch.spans``):
``train.step``, and in it ``train.forward`` and ``train.backward`` for each
microbatch and ``train.adamw``, each with device stamps on a CUDA device.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import spans
from ..models.model import Model
from ..tree import leaves, leaves_with_paths, tree_map, unflatten
from .optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    compress_decompress_with_feedback,
    zeros_like_error,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    error_feedback: Optional[Any] = None  # int8-compression residual


def init_train_state(
    model: Model, generator: torch.Generator, compress_grads: bool = False
) -> TrainState:
    params = model.init(generator)
    ef = zeros_like_error(params) if compress_grads else None
    return TrainState(params=params, opt=adamw_init(params), error_feedback=ef)


def train_state_template(model: Model, compress_grads: bool = False) -> TrainState:
    """A ``TrainState`` on the meta device, the structure, shapes and
    dtypes ``checkpoint.restore`` fills (the JAX package's
    ``jax.eval_shape`` of ``init_train_state``)."""
    params = model.param_specs()
    ef = zeros_like_error(params) if compress_grads else None
    return TrainState(params=params, opt=adamw_init(params), error_feedback=ef)


def loss_and_grads(
    model: Model, params: Any, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``jax.value_and_grad(model.loss, has_aux=True)``: (loss, metrics,
    grads in the params' tree and dtypes).  The grads are taken against
    detached aliases of the params, so the caller's tensors keep
    ``requires_grad=False``.  The leaves the model names in
    ``unread_by_loss`` (an audio model's token table) get zeros, as in
    JAX; any other leaf the loss does not reach makes autograd raise.
    Its ``train.forward`` and ``train.backward`` spans sit in the open
    ``train.step``, if any."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = leaves_with_paths(live)
    unread = model.unread_by_loss
    cuda = model.device.type == "cuda"
    step = spans.last_open("train.step")
    with torch.enable_grad():
        part = spans.begin("train.forward", step, device=cuda)
        loss, metrics = model.loss(live, batch)
        spans.end(part)
        part = spans.begin("train.backward", step, device=cuda)
        read = iter(torch.autograd.grad(loss, [p for path, p in flat if path not in unread]))
        spans.end(part)
    grads = [torch.zeros_like(p) if path in unread else next(read) for path, p in flat]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(live, grads)


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    num_microbatches: int = 1,
    compress_grads: bool = False,
):
    """Returns train_step(state, batch) -> (state, metrics).

    ``num_microbatches > 1``: the batch is split along its first axis; the
    microbatches' grads are summed into fp32 buffers and divided by their
    count, and the loss and metrics are their means (the JAX step's
    ``lax.scan``).
    """

    cuda = model.device.type == "cuda"

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        step = spans.begin("train.step")
        if num_microbatches == 1:
            loss, metrics, grads = loss_and_grads(model, state.params, batch)
        else:
            n = num_microbatches
            B = next(iter(batch.values())).shape[0]
            if B % n:
                raise ValueError(f"batch of {B} rows does not split into {n} microbatches")
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                state.params,
            )
            losses, metricses = [], []
            for i in range(n):
                mb = {k: v.reshape((n, B // n) + v.shape[1:])[i] for k, v in batch.items()}
                loss_i, metrics_i, g = loss_and_grads(model, state.params, mb)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                losses.append(loss_i)
                metricses.append(metrics_i)
            for acc in leaves(grads):
                acc.div_(n)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}

        ef = state.error_feedback
        if compress_grads and ef is not None:
            grads, ef = compress_decompress_with_feedback(grads, ef)

        part = spans.begin("train.adamw", step, device=cuda)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt
        )
        spans.end(part)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        spans.end(step)
        return TrainState(new_params, new_opt, ef), metrics

    return train_step


def make_serve_steps(model: Model):
    """(prefill_step, decode_step) for serving."""

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return prefill_step, decode_step
