"""Dreamer-V1's weights and optimizer states across the two packages.

The Dreamer-V1 modules name each submodule after its flax scope, so
Dreamer-V2's rules (``algos/dreamer_v2/convert.py``: ``to_flax`` and
``from_flax``) carry every leaf; the GRU cell's six Denses
(``GRUCell_0/{ir, iz, in, hr, hz, hn}``) take the dense rule, ``[in, out]``
to ``[out, in]``. The checkpoint holds the JAX keys (JAX
``dreamer_v1.py:620-634``): three models and three optimizers, no target
critic.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.convert import from_flax, to_flax
from sheeprl_tpu_torch.algos.dreamer_v3.convert import adam_from_optax, adam_to_optax
from sheeprl_tpu_torch.ops.optim import Adam

__all__ = ["MODEL_KEYS", "OPTIMIZER_KEYS", "checkpoint_state", "from_flax", "load_checkpoint_state", "to_flax"]

MODEL_KEYS = ("world_model", "actor", "critic")
OPTIMIZER_KEYS = ("world_optimizer", "actor_optimizer", "critic_optimizer")


def _names(module: nn.Module) -> Sequence[str]:
    return [n for n, _ in module.named_parameters()]


def checkpoint_state(wm: nn.Module, actor: nn.Module, critic: nn.Module, opts: Sequence[Adam]) -> Dict[str, Any]:
    """The models and optimizers in the JAX checkpoint's layout and keys."""
    models = (wm, actor, critic)
    state = {k: to_flax(m, m.state_dict()) for k, m in zip(MODEL_KEYS, models)}
    for k, opt, m in zip(OPTIMIZER_KEYS, opts, models):
        state[k] = adam_to_optax(opt, _names(m), lambda sd, m=m: to_flax(m, sd))
    return state


@torch.no_grad()
def load_checkpoint_state(state: Mapping[str, Any], wm: nn.Module, actor: nn.Module, critic: nn.Module, opts: Sequence[Adam]) -> None:
    """:func:`checkpoint_state` (the port's or the JAX package's) into the
    live modules and optimizers, in place."""
    models = (wm, actor, critic)
    for k, m in zip(MODEL_KEYS, models):
        m.load_state_dict(from_flax(m, state[k]))
    for k, opt, m in zip(OPTIMIZER_KEYS, opts, models):
        adam_from_optax(state[k], opt, _names(m), lambda tree, m=m: from_flax(m, tree))
