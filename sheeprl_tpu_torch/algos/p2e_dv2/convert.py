"""Plan2Explore over Dreamer-V1 and V2: weights and optimizer states across
the two packages.

Each model converts with ``algos/dreamer_v2/convert.py`` (the Dreamer-V1
and V2 modules share its rules), the ensemble with
``algos/p2e_dv3/convert.py``'s stacked rules over the ``_MLPBlock_0`` trunk
(the JAX vmapped tree, every leaf ``[N, ...]``). ``checkpoint_state``
writes a run's models and optimizers under the JAX checkpoint's keys
(JAX ``p2e_dv2_exploration.py:776-800``, ``p2e_dv1_exploration.py``
alike without the targets; the finetuning runs write the task models and
the exploration actor); ``load_checkpoint_state`` loads the port's or the
JAX package's back in place, the keys of the given models and optimizers
only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.convert import from_flax, to_flax
from sheeprl_tpu_torch.algos.dreamer_v3.convert import adam_from_optax, adam_to_optax
from sheeprl_tpu_torch.algos.p2e_dv3.convert import ensemble_from_flax, ensemble_to_flax
from sheeprl_tpu_torch.ops.optim import Adam

TRUNK = "_MLPBlock_0"
# each optimizer's checkpoint key -> the model it steps
OPTIMIZED = {
    "world_optimizer": "world_model",
    "actor_task_optimizer": "actor_task",
    "critic_task_optimizer": "critic_task",
    "actor_exploration_optimizer": "actor_exploration",
    "critic_exploration_optimizer": "critic_exploration",
    "ensemble_optimizer": "ensembles",
}


def converters(key: str, module: nn.Module):
    """``(to_flax, from_flax)`` of the model under checkpoint key ``key``,
    each over a tree keyed as its state dict."""
    if key == "ensembles":
        return (lambda sd: ensemble_to_flax(sd, TRUNK)), (lambda tree: ensemble_from_flax(tree, TRUNK))
    return (lambda sd: to_flax(module, sd)), (lambda tree: from_flax(module, tree))


def _names(module: nn.Module) -> list:
    return [n for n, _ in module.named_parameters()]


def checkpoint_state(models: Mapping[str, nn.Module], opts: Mapping[str, Adam]) -> Dict[str, Any]:
    """``models`` and ``opts`` (each keyed by its checkpoint key) in the JAX
    checkpoint layout."""
    state: Dict[str, Any] = {k: converters(k, m)[0](m.state_dict()) for k, m in models.items()}
    for key, opt in opts.items():
        model = OPTIMIZED[key]
        state[key] = adam_to_optax(opt, _names(models[model]), converters(model, models[model])[0])
    return state


@torch.no_grad()
def load_checkpoint_state(state: Mapping[str, Any], models: Mapping[str, nn.Module], opts: Optional[Mapping[str, Adam]] = None) -> None:
    """:func:`checkpoint_state`'s keys of ``models`` and ``opts`` (the
    port's or the JAX package's) into them, in place (a captured step keeps
    reading the same tensors)."""
    for key, m in models.items():
        m.load_state_dict(converters(key, m)[1](state[key]))
    for key, opt in (opts or {}).items():
        model = OPTIMIZED[key]
        adam_from_optax(state[key], opt, _names(models[model]), converters(model, models[model])[1])

