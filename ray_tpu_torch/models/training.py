"""Train-step factory: TrainState, the AdamW optimizer, the step.

Counterpart of ``ray_tpu/models/training.py`` on one device (``parallel/``
is not ported yet, so there is no mesh). The optimizer is the JAX
package's optax chain written out in torch, with optax's arithmetic:

    clip_by_global_norm(grad_clip)
    scale_by_adam(b1, b2, eps=1e-8, mu_dtype=moment_dtype)
    add_decayed_weights(weight_decay, mask=ndim > 1)
    scale_by_learning_rate(schedule)

Parameters, gradients and moments are nested dicts (and lists) of
tensors shaped like the parameters (the ``llama`` layout). The step updates parameters
and moments in place, the counterpart of the JAX step's ``donate``: the
state passed in is the state returned.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


def _leaves(tree) -> List[torch.Tensor]:
    """A tree's tensors in order; a tree nests dicts and lists (the MLP's
    parameters are a list of dicts), as JAX's pytrees do."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``like``'s dtype, as JAX makes a weakly typed
    scalar (so a bf16 operand's constant is rounded to bf16 first). A 0-d
    CPU tensor, which PyTorch treats as a scalar beside a CUDA tensor."""
    return torch.tensor(x, dtype=like.dtype)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in f32 (also
    for bf16 leaves, where optax's norm is rounded to bf16)."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32) ** 2
          for t in _leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The optax chain of :func:`make_optimizer`. ``init(params)`` gives
    ``{"count", "mu", "nu"}``; ``update(grads, opt_state, params)``
    applies one step to ``params`` and the moments in place."""

    schedule: Callable[[int], float]
    weight_decay: float
    b1: float
    b2: float
    grad_clip: float
    moment_dtype: Any = None
    eps: float = 1e-8

    def init(self, params) -> Dict[str, Any]:
        return {"count": 0,
                "mu": _map(lambda p: torch.zeros_like(
                    p, dtype=self.moment_dtype or p.dtype), params),
                "nu": _map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params) -> Dict[str, Any]:
        count = opt_state["count"]
        # optax reads the schedule at the count before the increment, and
        # divides by the bias corrections at the count after it.
        lr = float(self.schedule(count))
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        norm = global_norm(grads)
        clip = norm >= self.grad_clip  # optax: keep when norm < limit
        for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                                _leaves(opt_state["mu"]),
                                _leaves(opt_state["nu"])):
            g = torch.where(clip, g / norm.to(g.dtype)
                            * _scalar(self.grad_clip, g), g)
            m = _scalar(1 - self.b1, g) * g + _scalar(self.b1, mu) * mu
            v = _scalar(1 - self.b2, g) * (g * g) + _scalar(self.b2, nu) * nu
            u = (m / _scalar(bc1, m)) / (
                torch.sqrt(v / _scalar(bc2, v)) + _scalar(self.eps, v))
            if p.dim() > 1:
                u = u + _scalar(self.weight_decay, p) * p
            p.add_(u * _scalar(-lr, u))
            mu.copy_(m)
            nu.copy_(v)
        opt_state["count"] = count + 1
        return opt_state


def make_optimizer(
    learning_rate: float = 3e-4,
    *,
    warmup_steps: int = 100,
    total_steps: Optional[int] = None,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    moment_dtype: Any = None,
) -> AdamW:
    """AdamW with warmup (+ cosine when ``total_steps`` is given) and
    global-norm clipping. The warmup rises linearly from 0, so the first
    step's learning rate is 0. ``moment_dtype=torch.bfloat16`` halves the
    first moment's memory (the second stays in the parameters' dtype,
    as in optax)."""
    if total_steps is not None:
        decay = max(total_steps, warmup_steps + 1) - warmup_steps

        def schedule(count):
            if count < warmup_steps:
                return learning_rate * count / warmup_steps
            t = min(count - warmup_steps, decay)
            return learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay))
    elif warmup_steps > 0:
        def schedule(count):
            return learning_rate * min(count, warmup_steps) / warmup_steps
    else:
        def schedule(count):
            return learning_rate
    return AdamW(schedule, weight_decay, b1, b2, grad_clip, moment_dtype)


def init_train_state(params, tx: AdamW) -> TrainState:
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def make_train_step(loss_fn: Callable, tx: AdamW) -> Callable:
    """Returns ``(state, batch) -> (state, metrics)``, with
    ``loss_fn(params, batch) -> (scalar_loss, metrics_dict)``.

    The step updates ``state.params`` and the optimizer moments IN PLACE
    (the JAX step donates its state instead), so the returned state holds
    the same tensors. ``metrics["grad_norm"]`` is the global norm of the
    gradients before clipping. Metric values stay on the device."""

    def step(state: TrainState, batch):
        leaves = _leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = loss_fn(state.params, batch)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grad_tree = _unflatten(state.params, list(grads))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grad_tree)
        opt_state = tx.update(grad_tree, state.opt_state, state.params)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step


def make_eval_step(loss_fn: Callable) -> Callable:
    """Returns ``(params, batch) -> metrics``, with no gradient."""

    @torch.no_grad()
    def eval_fn(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_fn


def _unflatten(tree, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return _map(lambda _: next(it), tree)
