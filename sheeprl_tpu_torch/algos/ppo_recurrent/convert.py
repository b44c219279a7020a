"""Flax <-> port weight conversion for recurrent PPO.

PPO's rules (``algos/ppo/convert.py``: Dense ``[in, out]`` against
``nn.Linear.weight [out, in]``, HWIO convs, NatureCNN's feature rows from
HWC to CHW order, the nested LayerNorm) over the recurrent agent's scopes
(``pre_rnn_mlp``, ``post_rnn_mlp``, ``critic``, ``actor_backbone``,
``actor_head_i``), plus the LSTM: flax's ``OptimizedLSTMCell`` under
``ScanOptimizedLSTMCell_0`` holds eight ``DenseParams``, ``ii, if, ig, io``
(``kernel [in, H]``, no bias) and ``hi, hf, hg, ho`` (``kernel [H, H]``
and ``bias [H]``), which the port's ``LSTMCell`` holds concatenated in
gate order (``lstm.input_kernel [in, 4H]``, ``lstm.hidden_kernel [H,
4H]``, ``lstm.hidden_bias [4H]``), in flax's layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo import convert as ppo_convert

PREFIXES = {
    **ppo_convert._PREFIXES,
    "pre_rnn_mlp.": "pre_rnn_mlp/",
    "post_rnn_mlp.": "post_rnn_mlp/",
}
LSTM = "ScanOptimizedLSTMCell_0"
GATES = "ifgo"
# port LSTM tensor -> (flax DenseParams prefix, leaf)
_LSTM_LEAVES = {
    "lstm.input_kernel": ("i", "kernel"),
    "lstm.hidden_kernel": ("h", "kernel"),
    "lstm.hidden_bias": ("h", "bias"),
}


def agent_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``RecurrentPPOAgent`` from a JAX
    ``RecurrentPPOAgent`` param tree."""
    params = dict(tree["params"] if "params" in tree else tree)
    cell = params.pop(LSTM)
    out = ppo_convert.agent_from_flax(params, PREFIXES)
    for name, (kind, leaf) in _LSTM_LEAVES.items():
        parts = [np.asarray(cell[f"{kind}{g}"][leaf], dtype=np.float32) for g in GATES]
        out[name] = torch.from_numpy(np.ascontiguousarray(np.concatenate(parts, -1)))
    return out


def agent_to_flax(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX param tree (``{"params": ...}``) of a port state dict (or a
    tree keyed as one, such as an optimizer's moments), as numpy (bf16 as
    float32)."""
    sd = dict(sd)
    lstm = {name: sd.pop(name) for name in _LSTM_LEAVES}
    tree = ppo_convert.agent_to_flax(sd, PREFIXES)
    cell: Dict[str, Dict[str, np.ndarray]] = {}
    for name, (kind, leaf) in _LSTM_LEAVES.items():
        t = torch.as_tensor(lstm[name]).detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        for g, part in zip(GATES, np.split(a, 4, -1)):
            cell.setdefault(f"{kind}{g}", {})[leaf] = np.ascontiguousarray(part)
    tree["params"][LSTM] = cell
    return tree
