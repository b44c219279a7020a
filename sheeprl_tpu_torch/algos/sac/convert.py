"""Flax <-> port weight conversion for the SAC family (SAC, DroQ, SAC-AE).

The port's SAC-family modules are named after the flax scopes they mirror
(``Dense_0``, ``fc_mean``, ``LayerNorm_0``, ``Conv_0``, ``to_obs`` ...), so a
parameter's flax path is its dotted name with ``/`` and the flax leaf name.
What changes is the layout, by the port module that holds the parameter:

- ``nn.Linear`` (the port's ``Dense``): the flax kernel ``[in, out]`` is the
  weight ``[out, in]``;
- ``nn.Conv2d``: the flax kernel is HWIO, the torch weight OIHW;
- ``nn.ConvTranspose2d``: a flax ``ConvTranspose`` (``transpose_kernel=False``)
  correlates the stride-dilated input with its HWIO kernel as stored, torch
  with the spatially flipped kernel held as ``[in, out, kH, kW]``: the
  kernel is flipped in kH and kW and moved to ``[in, out, kH, kW]``
  (``algos/dreamer_v3/convert.py`` has the same rule);
- ``nn.LayerNorm``: ``scale`` is the weight;
- :class:`StackedDense` and :class:`StackedLayerNorm` (the critic ensemble,
  ``jax.vmap(critic.init)``'s stacked params, JAX ``sac/agent.py:228``) hold
  the flax leaves as they are, ``[n, in, out]`` kernels included, for one
  batched product over the ensemble.

:func:`from_flax` and :func:`to_flax` convert a whole tree both ways (a
leaf with no counterpart raises); the same functions carry Adam's moments,
which share the params' layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Converter = Tuple[Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]], Callable[[Mapping[str, Any]], Dict[str, Any]]]


class StackedDense(nn.Module):
    """``n`` flax ``Dense`` layers held stacked as flax's ``vmap`` init
    stacks them: ``kernel [n, in, out]`` and ``bias [n, out]``. The input
    is shared ``[B, in]`` or per member ``[n, B, in]``; the output is
    ``[n, B, out]``, computed in ``compute_dtype`` with the bias added after
    the product is rounded, as flax adds it."""

    def __init__(self, n: int, in_features: int, out_features: int, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))
        with torch.no_grad():
            for i in range(n):
                lecun_normal_(self.kernel[i], in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)[:, None, :]


class StackedLayerNorm(nn.Module):
    """``n`` flax ``LayerNorm``s (``scale``, ``bias`` ``[n, features]``) on
    ``[n, B, features]``, in fp32 with flax's statistics (the variance as
    ``E[x^2] - E[x]^2``) and epsilon (1e-6); the output is fp32."""

    def __init__(self, n: int, features: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n, features))
        self.bias = nn.Parameter(torch.zeros(n, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
        mul = torch.rsqrt(var + self.eps) * self.scale[:, None, :]
        return (x - mean) * mul + self.bias[:, None, :]


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init in place: a normal truncated at two
    standard deviations with variance ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def flax_init_(module: nn.Module) -> nn.Module:
    """Every ``nn.Linear`` and conv of ``module`` re-initialised as flax
    initialises it: lecun-normal kernels, zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, m.weight[0].numel())
            elif isinstance(m, nn.ConvTranspose2d):
                # flax's fan-in of a ConvTranspose kernel [kH, kW, in, out]
                lecun_normal_(m.weight, m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3])
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
    return module


def _rules(module: nn.Module) -> Dict[str, Tuple[str, str]]:
    """Each parameter's ``(flax path, layout)``: ``dense``, ``conv``,
    ``deconv`` or ``copy``."""
    out: Dict[str, Tuple[str, str]] = {}
    for prefix, m in module.named_modules():
        scope = prefix.replace(".", "/")
        base = f"{scope}/" if scope else ""
        if isinstance(m, nn.Linear):
            kinds = {"weight": ("kernel", "dense"), "bias": ("bias", "copy")}
        elif isinstance(m, nn.ConvTranspose2d):
            kinds = {"weight": ("kernel", "deconv"), "bias": ("bias", "copy")}
        elif isinstance(m, nn.Conv2d):
            kinds = {"weight": ("kernel", "conv"), "bias": ("bias", "copy")}
        elif isinstance(m, nn.LayerNorm):
            kinds = {"weight": ("scale", "copy"), "bias": ("bias", "copy")}
        elif isinstance(m, (StackedDense, StackedLayerNorm)):
            kinds = {n: (n, "copy") for n, _ in m.named_parameters(recurse=False)}
        else:
            continue
        for name, _ in m.named_parameters(recurse=False):
            leaf, kind = kinds[name]
            out[f"{prefix}.{name}" if prefix else name] = (base + leaf, kind)
    return out


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def from_flax(module: nn.Module, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of ``module`` (its parameters) from a flax param tree
    (``{"params": ...}`` or the inner tree) in fp32."""
    flat = _flatten(tree["params"] if "params" in tree else tree)
    rules = _rules(module)
    by_path = {path: (name, kind) for name, (path, kind) in rules.items()}
    extra = sorted(set(flat) - set(by_path))
    if extra:
        raise KeyError(f"flax params {extra} have no counterpart in {type(module).__name__}")
    out: Dict[str, torch.Tensor] = {}
    for name, (path, kind) in rules.items():
        if path not in flat:
            raise KeyError(f"{type(module).__name__}.{name} has no flax param {path!r}")
        a = np.asarray(flat[path], dtype=np.float32)
        if kind == "dense":
            a = a.T
        elif kind == "conv":
            a = a.transpose(3, 2, 0, 1)
        elif kind == "deconv":
            a = np.flip(a, (0, 1)).transpose(2, 3, 0, 1)
        out[name] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return out


def to_flax(module: nn.Module, sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The flax param tree (``{"params": ...}``) of a state dict of
    ``module``, or of any tree keyed as one (Adam's moments), as fp32 numpy."""
    rules = _rules(module)
    flat: Dict[str, np.ndarray] = {}
    for name, v in sd.items():
        if name not in rules:
            raise KeyError(f"{type(module).__name__} key {name!r} has no flax counterpart")
        path, kind = rules[name]
        a = torch.as_tensor(v).detach().float().cpu().numpy()
        if kind == "dense":
            a = a.T
        elif kind == "conv":
            a = a.transpose(2, 3, 1, 0)
        elif kind == "deconv":
            a = np.flip(a.transpose(2, 3, 0, 1), (0, 1))
        flat[path] = np.ascontiguousarray(a)
    return {"params": _unflatten(flat)}


def converter(module: nn.Module) -> Converter:
    """``(from_flax, to_flax)`` bound to ``module``, the pair that
    ``algos/dreamer_v3/convert.py::adam_to_optax`` and ``adam_from_optax``
    take."""
    return (lambda tree: from_flax(module, tree)), (lambda sd: to_flax(module, sd))


LOG_ALPHA: Converter = (
    lambda leaf: {"log_alpha": torch.tensor(np.asarray(leaf, dtype=np.float32).reshape(1))},
    lambda sd: np.asarray(torch.as_tensor(sd["log_alpha"]).detach().float().cpu().numpy(), dtype=np.float32),
)


@torch.no_grad()
def load_(module: nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy a flax param tree into ``module``'s parameters, in place (a
    captured graph keeps reading them)."""
    sd = from_flax(module, tree)
    for name, p in module.named_parameters():
        p.copy_(sd[name])
