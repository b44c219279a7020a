"""Adam and RMSProp with optax's semantics (port of
``sheeprl_tpu/ops/optim.py``: ``adam`` :32-48, ``optax.adam``/``optax.adamw``
behind ``optax.clip_by_global_norm``; ``rmsprop_tf`` and ``rmsprop``
:67-114), as plain tensor code over a list of parameters.

What sets it apart from ``torch.optim.Adam`` with
``clip_grad_norm_``: the gradients are scaled by ``max_norm / norm`` only
when ``norm >= max_norm`` (no ``+ 1e-6``), eps is added outside the square
root of the bias-corrected second moment, and ``weight_decay`` is AdamW's
decoupled ``lr * wd * param`` (optax adds it to the Adam direction before
the learning rate scales both).

RMSProp is optax's ``rmsprop`` with no bias correction and ``nu`` starting
at 0: ``rmsprop`` puts eps outside the square root (``eps_in_sqrt=False``,
as ``torch.optim.RMSprop`` does), ``rmsprop_tf`` inside. Its
``weight_decay`` is ``optax.add_decayed_weights`` chained in front of the
scaling: coupled L2, ``g + wd * param``, not Adam's decoupled form.
``momentum`` adds optax's ``trace`` after the learning rate; 0 means none.
``sgd`` is not ported: no ported algorithm selects it.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence, Union

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

    def state_tensors(self) -> List[torch.Tensor]:
        """Every state tensor ``step`` writes in place."""
        return [*self.mu, *self.nu, self.count]

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


class RMSProp:
    """optax's RMSProp behind ``add_decayed_weights`` (when
    ``weight_decay``) and global-norm clipping (when ``max_grad_norm >
    0``). ``step(grads)`` updates ``params`` in place and returns the
    gradients' global norm before clipping; ``schedule_steps`` decays the
    learning rate linearly to 0 as :class:`Adam` does.

    The state lives on the parameters' device and is updated in place, in
    optax's fields: ``nu`` (``ScaleByRmsState``), ``mu`` as well when
    ``centered`` (``ScaleByRStdDevState``), ``trace`` when ``momentum``
    (``TraceState``, holding the update after the learning rate, sign
    included) and ``count`` for a schedule (``ScaleByScheduleState``).
    Each update::

        g  = clip(g) + wd * p
        nu = decay * nu + (1 - decay) * g^2          mu = decay * mu + (1 - decay) * g
        d  = nu (- mu^2 when centered)
        u  = g / (sqrt(d) + eps)   or   g * rsqrt(d + eps) with eps in the root
        u  = -lr * u;  trace = u + momentum * trace;  u = trace
        p  = p + u
    """

    def __init__(
        self,
        params: Sequence[torch.nn.Parameter],
        lr: float = 1e-3,
        alpha: float = 0.99,
        eps: float = 1e-8,
        momentum: float = 0.0,
        centered: bool = False,
        weight_decay: float = 0.0,
        max_grad_norm: float = 0.0,
        eps_in_sqrt: bool = False,
        schedule_steps: int = 0,
    ) -> None:
        self.params = list(params)
        self.lr, self.decay, self.eps = float(lr), float(alpha), float(eps)
        self.momentum = float(momentum or 0.0)
        self.centered = bool(centered)
        self.weight_decay = float(weight_decay or 0.0)
        self.max_grad_norm = float(max_grad_norm or 0.0)
        self.eps_in_sqrt = bool(eps_in_sqrt)
        self.schedule_steps = int(schedule_steps or 0)
        self.count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in self.params]  # noqa: E731
        self.nu = zeros()
        self.mu: Optional[List[torch.Tensor]] = zeros() if self.centered else None
        self.trace: Optional[List[torch.Tensor]] = zeros() if self.momentum else None

    def state_tensors(self) -> List[torch.Tensor]:
        """Every state tensor ``step`` writes in place."""
        return [*self.nu, *(self.mu or ()), *(self.trace or ()), self.count]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        grads = [g.detach() for g in grads]
        norm = global_norm(grads)
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm, norm)
        if self.weight_decay:
            grads = torch._foreach_add(grads, torch._foreach_mul(self.params, self.weight_decay))
        lr = self.lr
        if self.schedule_steps > 0:
            done = self.count.clamp(0, self.schedule_steps).float() / self.schedule_steps
            lr = self.lr * (1 - done)
        self.count.add_(1)
        decay = self.decay
        torch._foreach_mul_(self.nu, decay)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - decay))
        denom = self.nu
        if self.mu is not None:
            torch._foreach_mul_(self.mu, decay)
            torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - decay))
            denom = torch._foreach_sub(self.nu, torch._foreach_mul(self.mu, self.mu))
        if self.eps_in_sqrt:
            scaling = [torch.rsqrt(d + self.eps) for d in denom]
        else:
            scaling = torch._foreach_reciprocal(torch._foreach_add(torch._foreach_sqrt(denom), self.eps))
        update = torch._foreach_mul(torch._foreach_mul(scaling, grads), -lr)
        if self.trace is not None:
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, update)
            update = self.trace
        torch._foreach_add_(self.params, update)
        return norm


Optimizer = Union[Adam, RMSProp]


def rmsprop(
    params: Sequence[torch.nn.Parameter], opt_cfg: Mapping[str, Any], clip: float = 0.0, schedule_steps: int = 0, eps_in_sqrt: bool = False
) -> RMSProp:
    """RMSProp from a config group (``lr``, ``alpha``, ``eps``, ``momentum``,
    ``centered``, ``weight_decay``) with the algo's clipping: eps outside
    the square root, ``alpha`` 0.99 by default (JAX ``rmsprop``)."""
    return RMSProp(
        params,
        lr=float(opt_cfg["lr"]),
        alpha=float(opt_cfg.get("alpha", 0.9 if eps_in_sqrt else 0.99)),
        eps=float(opt_cfg.get("eps", 1e-8)),
        momentum=float(opt_cfg.get("momentum", 0.0) or 0.0),
        centered=bool(opt_cfg.get("centered", False)),
        weight_decay=float(opt_cfg.get("weight_decay", 0.0) or 0.0),
        max_grad_norm=float(clip or 0.0),
        eps_in_sqrt=eps_in_sqrt,
        schedule_steps=schedule_steps,
    )


def rmsprop_tf(params: Sequence[torch.nn.Parameter], opt_cfg: Mapping[str, Any], clip: float = 0.0, schedule_steps: int = 0) -> RMSProp:
    """TF-style RMSProp: eps inside the square root, ``alpha`` 0.9 by
    default (JAX ``rmsprop_tf``)."""
    return rmsprop(params, opt_cfg, clip, schedule_steps, eps_in_sqrt=True)


_FACTORIES = {"adam": adam, "rmsprop": rmsprop, "rmsprop_tf": rmsprop_tf}


def build_optimizer(
    params: Sequence[torch.nn.Parameter], opt_cfg: Mapping[str, Any], clip: float = 0.0, schedule_steps: int = 0
) -> Optimizer:
    """The optimizer a config group's ``_target_`` names (its last part:
    ``adam``, ``rmsprop`` or ``rmsprop_tf``; Adam when it has none), with
    the algo's clipping and the linear decay's length."""
    name = str(opt_cfg.get("_target_", "adam")).rsplit(".", 1)[-1]
    if name not in _FACTORIES:
        raise NotImplementedError(f"optimizer {name!r} is not ported to sheeprl_tpu_torch (ported: {sorted(_FACTORIES)})")
    return _FACTORIES[name](params, opt_cfg, clip, schedule_steps)
