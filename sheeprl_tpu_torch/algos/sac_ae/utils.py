"""SAC-AE helpers (port of ``sheeprl_tpu/algos/sac_ae/utils.py``): its
metrics, the observation prep and the reconstruction target."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS as _SAC_KEYS
from sheeprl_tpu_torch.algos.sac.utils import test  # noqa: F401  (the SAC-AE API)

AGGREGATOR_KEYS = _SAC_KEYS | {"Loss/reconstruction_loss"}


def prepare_obs(obs: Mapping[str, Any], cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (), num_envs: int = 1) -> Dict[str, np.ndarray]:
    """The player's input of ``num_envs`` observations: the encoder keys with
    a leading env axis, pixels kept uint8 (they are folded and scaled on
    the device, ``agent.encoder_inputs``), vectors flat fp32."""
    out: Dict[str, np.ndarray] = {}
    for k in cnn_keys:
        v = np.asarray(obs[k])
        # a lone observation ([H, W, C] or a stack [S, H, W, C]) gets the env axis
        out[k] = v[None] if v.ndim == 3 or v.shape[0] != num_envs else v
    out.update({k: np.asarray(obs[k], np.float32).reshape(num_envs, -1) for k in mlp_keys})
    return out


def preprocess_target(x: torch.Tensor, bits: int = 5) -> torch.Tensor:
    """The reconstruction target of uint8 pixels: quantized to ``bits`` and
    centred, with no dequantization noise (JAX ``sac_ae.py:78-84``)."""
    bins = 2**bits
    x = torch.floor(x.float() / 2 ** (8 - bits))
    return x / bins + 0.5 / bins - 0.5
