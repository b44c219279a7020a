"""Dreamer-V2's weights and optimizer states across the two packages.

The port's Dreamer-V2 modules name each submodule after its flax scope
(``agent.py``), so a rule per module type carries every leaf: a ``Dense``
kernel ``[in, out]`` is ``nn.Linear.weight`` ``[out, in]``, a conv kernel
HWIO is OIHW, a transposed conv's HWIO kernel is flipped in kH and kW and
moved to ``[in, out, kH, kW]`` (Dreamer-V3's rule), the repo's LayerNorm
wrapper nests a flax ``LayerNorm`` (``LayerNorm_i/LayerNorm_0/{scale,
bias}``) and the GRU cell keeps its ``Dense_0`` kernel ``[in, out]`` with
its ``LayerNorm_0``. ``to_flax(module, tree)`` gives the JAX param tree of
a state dict (or of any tree keyed as one, such as Adam's moments);
``from_flax(module, tree)`` the state dict of a JAX param tree. A leaf that
either side lacks raises. ``checkpoint_state`` and
``load_checkpoint_state`` hold the JAX checkpoint's models and optimizers
(Dreamer-V3's ``adam_to_optax``/``adam_from_optax`` nesting).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.convert import _params, adam_from_optax, adam_to_optax
from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell
from sheeprl_tpu_torch.ops.optim import Adam

Rule = Tuple[str, str]  # (flax path, layout: copy | dense | conv | deconv)


def rules(module: nn.Module) -> Dict[str, Rule]:
    """Each state-dict key of ``module`` -> its flax path and layout."""
    out: Dict[str, Rule] = {}
    for name, m in module.named_modules():
        path = name.replace(".", "/")
        if isinstance(m, LayerNormGRUCell):
            out[f"{name}.kernel"] = (f"{path}/Dense_0/kernel", "copy")
            if m.bias is not None:
                out[f"{name}.bias"] = (f"{path}/Dense_0/bias", "copy")
            if m.norm is not None:
                out[f"{name}.norm.weight"] = (f"{path}/LayerNorm_0/LayerNorm_0/scale", "copy")
                out[f"{name}.norm.bias"] = (f"{path}/LayerNorm_0/LayerNorm_0/bias", "copy")
            continue
        if name.endswith(".norm") and isinstance(module.get_submodule(name.rsplit(".", 1)[0]), LayerNormGRUCell):
            continue
        if isinstance(m, nn.LayerNorm):
            out[f"{name}.weight"] = (f"{path}/LayerNorm_0/scale", "copy")
            out[f"{name}.bias"] = (f"{path}/LayerNorm_0/bias", "copy")
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            layout = "deconv" if isinstance(m, nn.ConvTranspose2d) else "conv" if isinstance(m, nn.Conv2d) else "dense"
            out[f"{name}.weight"] = (f"{path}/kernel", layout)
            if m.bias is not None:
                out[f"{name}.bias"] = (f"{path}/bias", "copy")
    return out


def to_flax(module: nn.Module, sd: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"params": nested}`` of numpy fp32 leaves from a tree keyed as
    ``module``'s state dict."""
    table = rules(module)
    tree: Dict[str, Any] = {}
    for name, v in sd.items():
        if name not in table:
            raise KeyError(f"{type(module).__name__} key with no flax counterpart: {name!r}")
        path, layout = table[name]
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.float32)
        if layout == "dense":
            a = a.T
        elif layout == "conv":  # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        elif layout == "deconv":  # [in, out, kH, kW] -> HWIO, flipped back
            a = np.flip(a.transpose(2, 3, 0, 1), (0, 1))
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def from_flax(module: nn.Module, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``module``'s state dict from a JAX param tree; every leaf is used."""
    flat = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    for name, (path, layout) in rules(module).items():
        if path not in flat:
            raise KeyError(f"{type(module).__name__} key {name!r} has no leaf {path!r} in the flax tree")
        a = flat.pop(path)
        if layout == "dense":
            a = a.T
        elif layout == "conv":
            a = a.transpose(3, 2, 0, 1)
        elif layout == "deconv":
            a = np.flip(a, (0, 1)).transpose(2, 3, 0, 1)
        out[name] = torch.from_numpy(np.array(a, dtype=np.float32))
    if flat:
        raise KeyError(f"{type(module).__name__} leaves with no port counterpart: {sorted(flat)}")
    return out


def _names(module: nn.Module) -> Sequence[str]:
    return [n for n, _ in module.named_parameters()]


MODEL_KEYS = ("world_model", "actor", "critic", "target_critic")
OPTIMIZER_KEYS = ("world_optimizer", "actor_optimizer", "critic_optimizer")


def checkpoint_state(wm: nn.Module, actor: nn.Module, critic: nn.Module, target_critic: nn.Module, opts: Sequence[Adam]) -> Dict[str, Any]:
    """The models and optimizers in the JAX checkpoint's layout and keys
    (JAX ``dreamer_v2.py:662-669``)."""
    models = (wm, actor, critic, target_critic)
    state = {k: to_flax(m, m.state_dict()) for k, m in zip(MODEL_KEYS, models)}
    for key, opt, m in zip(OPTIMIZER_KEYS, opts, models):
        state[key] = adam_to_optax(opt, _names(m), lambda sd, m=m: to_flax(m, sd))
    return state


@torch.no_grad()
def load_checkpoint_state(state: Mapping[str, Any], wm: nn.Module, actor: nn.Module, critic: nn.Module, target_critic: nn.Module, opts: Sequence[Adam]) -> None:
    """:func:`checkpoint_state` (the port's or the JAX package's) into the
    live modules and optimizers, in place."""
    models = (wm, actor, critic, target_critic)
    for key, m in zip(MODEL_KEYS, models):
        m.load_state_dict(from_flax(m, state[key]))
    for key, opt, m in zip(OPTIMIZER_KEYS, opts, models):
        adam_from_optax(state[key], opt, _names(m), lambda tree, m=m: from_flax(m, tree))
