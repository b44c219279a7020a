"""Adam with optax's semantics (port of ``sheeprl_tpu/ops/optim.py::adam``,
``:32-48``: ``optax.adam``/``optax.adamw`` behind
``optax.clip_by_global_norm``), as plain tensor code over a list of
parameters.

What sets it apart from ``torch.optim.Adam`` with
``clip_grad_norm_``: the gradients are scaled by ``max_norm / norm`` only
when ``norm >= max_norm`` (no ``+ 1e-6``), eps is added outside the square
root of the bias-corrected second moment, and ``weight_decay`` is AdamW's
decoupled ``lr * wd * param`` (optax adds it to the Adam direction before
the learning rate scales both). ``sgd`` and the ``rmsprop``s come with the
algorithms that use them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.stack(torch._foreach_norm(list(tensors))).square().sum().sqrt()


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, norm: torch.Tensor) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: ``g / norm * max_norm`` where
    ``norm >= max_norm``, ``g`` otherwise, chosen per tensor on the device
    (no host sync). ``torch.where`` keeps the branch not taken out of the
    result, as ``lax.select`` does: at a zero norm the clipped branch is
    0/0, and the gradients stay zero."""
    keep = norm < max_norm
    clipped = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    return [torch.where(keep, g, c) for g, c in zip(grads, clipped)]


class Adam:
    """optax's Adam (``adamw`` when ``weight_decay``), with global-norm
    clipping in front when ``max_grad_norm > 0``. ``step(grads)`` updates
    ``params`` in place (no autograd) and returns the gradients' global norm
    before clipping. With ``schedule_steps`` the learning rate decays
    linearly to 0 over that many steps (``optax.linear_schedule``).
    Multi-tensor (``torch._foreach_*``) ops, each rounding
    as optax's elementwise expression does.

    Every piece of state lives on the parameters' device and is updated in
    place: ``mu``, ``nu`` and ``count`` (optax's ``ScaleByAdamState``, the
    step count an int32 tensor), so a CUDA graph that captured ``step``
    reads and writes the same memory at every replay, and the bias
    corrections ``1 - b**count`` are computed on the device in fp32."""

    def __init__(
        self,
        params: Sequence[torch.nn.Parameter],
        lr: float = 1e-3,
        betas: Sequence[float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        max_grad_norm: float = 0.0,
        schedule_steps: int = 0,
    ) -> None:
        self.params = list(params)
        # anneal_lr: optax's linear_schedule(lr, 0, schedule_steps), read at
        # the step count before each update, on the device
        self.schedule_steps = int(schedule_steps or 0)
        self.lr, self.eps, self.weight_decay = float(lr), float(eps), float(weight_decay)
        self.b1, self.b2 = (float(b) for b in betas)
        self.max_grad_norm = float(max_grad_norm or 0.0)
        self.count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in self.params]
        self.nu = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        grads = [g.detach() for g in grads]
        norm = global_norm(grads)
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm, norm)
        lr = self.lr
        if self.schedule_steps > 0:
            done = self.count.clamp(0, self.schedule_steps).float() / self.schedule_steps
            lr = self.lr * (1 - done)
        self.count.add_(1)
        # optax's bias corrections, 1 - decay**count, in fp32 on the device
        n = self.count.float()
        c1 = 1 - torch.full_like(n, self.b1) ** n
        c2 = 1 - torch.full_like(n, self.b2) ** n
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - self.b2))
        # mu_hat / (sqrt(nu_hat) + eps)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, c2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(self.mu, c1), denom)
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_sub_(self.params, torch._foreach_mul(update, lr))
        return norm


def adam(params: Sequence[torch.nn.Parameter], opt_cfg: dict, clip: float = 0.0, schedule_steps: int = 0) -> Adam:
    """The optimizer of a config group (``lr``, ``eps``, ``weight_decay``,
    ``betas``) with the algo's ``clip_gradients`` and, for ``anneal_lr``,
    the linear decay's length."""
    return Adam(
        params,
        lr=float(opt_cfg["lr"]),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
        eps=float(opt_cfg["eps"]),
        weight_decay=float(opt_cfg.get("weight_decay", 0.0) or 0.0),
        max_grad_norm=float(clip or 0.0),
        schedule_steps=schedule_steps,
    )
