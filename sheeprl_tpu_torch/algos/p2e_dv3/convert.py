"""Flax <-> port conversion for Plan2Explore on Dreamer-V3.

The world model, the two actors and every critic convert with
``algos/dreamer_v3/convert.py``. What is new is the ensemble: the JAX
package's vmapped param tree (``_LNMLP_0/Dense_i``,
``_LNMLP_0/LayerNorm_i/LayerNorm_0`` and the output ``Dense_0``, every leaf
with a leading ``[N]`` axis) is the stacked module's state as it is
(``kernel [N, in, out]``, ``bias [N, out]``, LayerNorm ``scale``/``bias``
``[N, units]``); the Dreamer-V1 and V2 members' trunk is ``_MLPBlock_0``
(``trunk=``).

``checkpoint_state`` writes the exploration run's models, optimizers and
Moments in the JAX checkpoint layout (JAX ``p2e_dv3_exploration.py``
:901-936), each optimizer through ``adam_to_optax``;
``load_checkpoint_state`` loads such a state (the port's or the JAX
package's) back in place, the models alone when no optimizers are given.
``TASK_KEYS`` names Dreamer-V3's checkpoint keys as P2E stores them.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.convert import (
    _params,
    _to_flax,
    actor_from_flax,
    actor_to_flax,
    adam_from_optax,
    adam_to_optax,
    critic_from_flax,
    critic_to_flax,
    world_model_from_flax,
    world_model_to_flax,
)
from sheeprl_tpu_torch.algos.p2e_dv3.agent import P2EAgent
from sheeprl_tpu_torch.ops.math import MomentsState
from sheeprl_tpu_torch.ops.optim import Adam

# Dreamer-V3's checkpoint keys (``dreamer_v3.checkpoint_state``) -> P2E's
TASK_KEYS = {
    "world_model": "world_model",
    "actor": "actor_task",
    "critic": "critic_task",
    "target_critic": "target_critic_task",
    "world_optimizer": "world_optimizer",
    "actor_optimizer": "actor_task_optimizer",
    "critic_optimizer": "critic_task_optimizer",
    "moments": "moments_task",
}
# each optimizer's checkpoint key -> the model it steps
OPTIMIZED = {
    "world_optimizer": "world_model",
    "actor_task_optimizer": "actor_task",
    "critic_task_optimizer": "critic_task",
    "ensemble_optimizer": "ensembles",
    "actor_exploration_optimizer": "actor_exploration",
}


def _ensemble_rules(trunk: str) -> Tuple[Tuple[Tuple[str, str], ...], Tuple[Tuple[str, str], ...]]:
    """The port's ensemble names to the flax paths of the vmapped tree, and
    back; ``trunk`` is the members' MLP scope (``_LNMLP_0`` in Dreamer-V3,
    ``_MLPBlock_0`` in Dreamer-V1 and V2)."""
    to = (
        (r"linears\.(\d+)\.(kernel|bias)", trunk + r"/Dense_\1/\2"),
        (r"norms\.(\d+)\.(scale|bias)", trunk + r"/LayerNorm_\1/LayerNorm_0/\2"),
        (r"head\.(kernel|bias)", r"Dense_0/\1"),
    )
    back = (
        (trunk + r"/Dense_(\d+)/(kernel|bias)", r"linears.\1.\2"),
        (trunk + r"/LayerNorm_(\d+)/LayerNorm_0/(scale|bias)", r"norms.\1.\2"),
        (r"Dense_0/(kernel|bias)", r"head.\1"),
    )
    return to, back


def _rename(name: str, rules: Tuple[Tuple[str, str], ...]) -> Optional[str]:
    for pattern, repl in rules:
        if re.fullmatch(pattern, name):
            return re.sub(pattern, repl, name)
    return None


def ensemble_from_flax(tree: Mapping[str, Any], trunk: str = "_LNMLP_0") -> Dict[str, torch.Tensor]:
    """State dict of the port's ``Ensemble`` from the JAX vmapped ensemble
    tree; a leaf with no port counterpart raises."""
    back = _ensemble_rules(trunk)[1]
    out: Dict[str, torch.Tensor] = {}
    for path, a in _params(tree).items():
        name = _rename(path, back)
        if name is None:
            raise KeyError(f"ensemble leaf with no port counterpart: {path!r}")
        out[name] = torch.from_numpy(np.array(a, dtype=np.float32))
    return out


def ensemble_to_flax(sd: Mapping[str, Any], trunk: str = "_LNMLP_0") -> Dict[str, Any]:
    """The JAX vmapped ensemble tree of a port ``Ensemble`` state dict (or
    of a tree keyed as one)."""
    to = _ensemble_rules(trunk)[0]

    def path_of(name: str) -> Optional[Tuple[str, str]]:
        path = _rename(name, to)
        return None if path is None else (path, "copy")

    return _to_flax(sd, path_of, "ensemble")


Converters = Tuple[Callable[[Mapping[str, Any]], Any], Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]]
_CONVERTERS: Dict[str, Converters] = {
    "world_model": (world_model_to_flax, world_model_from_flax),
    "actor_task": (actor_to_flax, actor_from_flax),
    "critic_task": (critic_to_flax, critic_from_flax),
    "target_critic_task": (critic_to_flax, critic_from_flax),
    "actor_exploration": (actor_to_flax, actor_from_flax),
    "ensembles": (ensemble_to_flax, ensemble_from_flax),
}


def _names(module: nn.Module) -> list:
    return [n for n, _ in module.named_parameters()]


def _moments(m: MomentsState) -> Dict[str, np.ndarray]:
    return {k: np.array(getattr(m, k).item(), dtype=np.float32) for k in ("low", "high")}


def checkpoint_state(
    agent: P2EAgent, opts: Mapping[str, Adam], moments_task: MomentsState, moments_exploration: Mapping[str, MomentsState]
) -> Dict[str, Any]:
    """The exploration run's models, optimizers (``opts`` keyed by their
    checkpoint keys) and Moments in the JAX checkpoint layout."""
    state: Dict[str, Any] = {}
    for key, (to_flax, _) in _CONVERTERS.items():
        state[key] = to_flax(getattr(agent, key).state_dict())
    for key, model in OPTIMIZED.items():
        state[key] = adam_to_optax(opts[key], _names(getattr(agent, model)), _CONVERTERS[model][0])
    state["moments_task"] = _moments(moments_task)
    state["critics_exploration"] = {}
    for k, c in agent.critics_exploration.items():
        state["critics_exploration"][k] = {
            "module": critic_to_flax(c["critic"].state_dict()),
            "target_module": critic_to_flax(c["target"].state_dict()),
        }
        state[f"critic_exploration_optimizer_{k}"] = adam_to_optax(
            opts[f"critic_exploration_optimizer_{k}"], _names(c["critic"]), critic_to_flax
        )
        state[f"moments_exploration_{k}"] = _moments(moments_exploration[k])
    return state


def _fill(moments: MomentsState, saved: Mapping[str, Any]) -> None:
    moments.low.fill_(float(np.asarray(saved["low"])))
    moments.high.fill_(float(np.asarray(saved["high"])))


@torch.no_grad()
def load_checkpoint_state(
    state: Mapping[str, Any],
    agent: P2EAgent,
    opts: Optional[Mapping[str, Adam]] = None,
    moments_task: Optional[MomentsState] = None,
    moments_exploration: Optional[Mapping[str, MomentsState]] = None,
) -> None:
    """:func:`checkpoint_state` back into the live modules, optimizers and
    Moments, in place (a captured train step keeps reading the same
    tensors). Takes the port's checkpoints and the JAX package's."""
    for key, (_, from_flax) in _CONVERTERS.items():
        getattr(agent, key).load_state_dict(from_flax(state[key]))
    for k, c in agent.critics_exploration.items():
        c["critic"].load_state_dict(critic_from_flax(state["critics_exploration"][k]["module"]))
        c["target"].load_state_dict(critic_from_flax(state["critics_exploration"][k]["target_module"]))
    if opts is not None:
        for key, model in OPTIMIZED.items():
            adam_from_optax(state[key], opts[key], _names(getattr(agent, model)), _CONVERTERS[model][1])
        for k, c in agent.critics_exploration.items():
            key = f"critic_exploration_optimizer_{k}"
            adam_from_optax(state[key], opts[key], _names(c["critic"]), critic_from_flax)
    if moments_task is not None:
        _fill(moments_task, state["moments_task"])
    for k, m in (moments_exploration or {}).items():
        _fill(m, state[f"moments_exploration_{k}"])
