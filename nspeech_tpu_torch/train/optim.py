"""Optimizer and learning-rate schedules: port of
``nspeech_tpu/train/optim.py`` and of the optax chain it builds.

Tacotron-1 (and WaveNet) train with Adam and the Noam schedule,
Tacotron-2 with Adam and an exponential decay with a half-life. The update
is optax's ``chain(clip_by_global_norm(1.0), scale_by_adam(b1, b2, eps=1e-8),
scale_by_learning_rate(schedule))`` written out: the gradients are clipped
before Adam, and only when their global norm reaches the limit (then
scaled by ``limit / norm``; ``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6`` at every step, another function). The schedule reads the
update count before it is incremented, so step 0 uses ``schedule(0)``.
The optimizer state is a plain tree (``count``, ``mu``, ``nu``) that a
checkpoint holds as it is.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch.utils.tree import tree_leaves, tree_map


def noam_schedule(init_lr: float, warmup_steps: float = 4000.0):
    def schedule(step):
        s = step + 1.0
        return init_lr * warmup_steps ** 0.5 * min(s * warmup_steps ** -1.5,
                                                   s ** -0.5)

    return schedule


def exponential_halflife_schedule(init_lr: float, halflife: float):
    def schedule(step):
        return init_lr * 0.5 ** (step / halflife)

    return schedule


def make_schedule(cfg: Config, kind: str) -> Callable[[int], float]:
    """kind: 'noam' (taco1/wavenet), 'halflife' (taco2) or 'constant'."""
    init_lr = cfg.initial_learning_rate
    if kind == "halflife":
        return exponential_halflife_schedule(init_lr,
                                             cfg.learning_rate_decay_halflife)
    if kind == "noam":
        if cfg.decay_learning_rate:
            return noam_schedule(init_lr)
        return lambda step: init_lr
    if kind == "constant":
        return lambda step: init_lr
    raise ValueError(f"Unknown schedule kind: {kind}")


SCHEDULE_BY_MODEL = {
    "taco1": "noam",
    "taco2": "halflife",
    "wavenet": "noam",
    "simple_wavenet": "noam",
}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (optax's order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree_leaves(tree)))


class Adam:
    """Global-norm clip -> Adam (bias-corrected) -> -lr * schedule(count)."""

    def __init__(self, schedule: Callable[[int], float], b1: float, b2: float,
                 eps: float = 1e-8, gradient_clip: float = 1.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.gradient_clip = gradient_clip

    def init(self, params) -> Dict:
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def scalars(self, count: int) -> Tuple[float, float, float]:
        """``(lr, c1, c2)`` of the update at ``count`` (the state's count
        before it): the negated learning rate ``-schedule(count)`` and the
        bias corrections of the two moments, as float32 values."""
        return (-float(self.schedule(count)), _bias_correction(self.b1, count + 1),
                _bias_correction(self.b2, count + 1))

    def scalar_tensors(self, count: int, moment: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """:meth:`scalars` as 0-dim tensors on ``moment``'s device, in its
        dtype promoted to float32 (a Python float meets a float64 moment
        in float64)."""
        dtype = torch.promote_types(moment.dtype, torch.float32)
        return tuple(torch.full((), v, dtype=dtype, device=moment.device)
                     for v in self.scalars(count))

    def update(self, grads, opt_state, norm=None,
               scalars=None) -> Tuple[object, Dict]:
        """(updates to add to the params, new optimizer state). The clip
        reads ``norm``, the global norm of the whole gradient:
        ``global_norm(grads)`` unless given (a tensor-parallel step's
        ``grads`` are one model rank's slices of it). ``scalars`` are
        :meth:`scalar_tensors` of the state's count (a CUDA graph's,
        filled before each replay), made here unless given."""
        b1, b2 = self.b1, self.b2
        norm = global_norm(grads) if norm is None else norm
        clip = self.gradient_clip
        # optax's select(norm < clip, g, g / norm * clip), on the device
        g = tree_map(lambda t: torch.where(norm < clip, t, t / norm * clip),
                     grads)
        count = opt_state["count"] + 1
        mu = tree_map(lambda t, m: (1 - b1) * t + b1 * m, g, opt_state["mu"])
        nu = tree_map(lambda t, v: (1 - b2) * t * t + b2 * v, g, opt_state["nu"])
        if scalars is None:
            scalars = self.scalar_tensors(opt_state["count"], tree_leaves(mu)[0])
        lr, c1, c2 = scalars
        by_c1, by_c2 = _divide_by(c1), _divide_by(c2)
        updates = tree_map(
            lambda m, v: lr * (by_c1(m) / (torch.sqrt(by_c2(v)) + self.eps)), mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}


def _divide_by(c: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> x / c`` for a 0-dim tensor ``c``, with the bits of PyTorch's
    division by the Python float ``c`` holds. Its CUDA kernels divide by a
    host scalar as a product with the scalar's reciprocal (rounded in the
    tensor's dtype), so on CUDA this is that product; the CPU divides."""
    if c.is_cuda:
        r = torch.reciprocal(c)
        return lambda x: torch.mul(x, r)
    return lambda x: torch.div(x, c)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` as optax gets it in float32: the float32 decay
    to the power ``count`` (XLA's power is close to correctly rounded),
    rounded to float32, then the difference in float32. Near count 1 the
    difference loses most of its digits, so the rounding order shows."""
    power = np.float32(float(np.float32(decay)) ** count)
    return float(np.float32(1.0) - power)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def make_optimizer(cfg: Config, model_name: str, gradient_clip: float = 1.0):
    """(optimizer, schedule) for ``model_name``'s recipe."""
    schedule = make_schedule(cfg, SCHEDULE_BY_MODEL.get(model_name, "noam"))
    return Adam(schedule, cfg.adam["beta1"], cfg.adam["beta2"],
                gradient_clip=gradient_clip), schedule
