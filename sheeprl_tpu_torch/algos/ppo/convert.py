"""Flax <-> port weight conversion for PPO.

The JAX ``PPOAgent``'s param tree (``{"params": {...}}``, as its
checkpoints hold it) becomes the state dict of the port's ``PPOAgent`` and
back; Adam's moments share the layout. The rules:

- a flax ``Dense`` kernel ``[in, out]`` is ``nn.Linear.weight [out, in]``;
- a flax conv kernel is HWIO, a torch one OIHW;
- flax flattens ``NatureCNN``'s last map ``[H, W, C]`` in HWC order before
  its feature ``Dense``, the port in CHW order: that kernel's input rows
  are permuted from HWC to CHW order;
- the repo's LayerNorm wrapper nests a flax ``LayerNorm``:
  ``.../LayerNorm_i/LayerNorm_0/{scale,bias}``.

Every leaf is converted; a leaf with no counterpart raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_CNN = "CNNEncoder_0/NatureCNN_0"
_PREFIXES = {
    "mlp_encoder.mlp.": "MLPEncoder_0/MLP_0/",
    "critic.": "critic/",
    "actor_backbone.": "actor_backbone/",
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
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


def _flax_path(name: str, prefixes: Mapping[str, str] = _PREFIXES) -> Tuple[str, str]:
    """(flax path, kind) of a port state-dict key; kind is ``dense``,
    ``conv``, ``fc`` (NatureCNN's feature Dense) or ``plain``. ``prefixes``
    maps the port's MLP modules to their flax scopes."""
    m = re.fullmatch(r"cnn_encoder\.cnn\.convs\.(\d+)\.(weight|bias)", name)
    if m:
        leaf = "kernel" if m[2] == "weight" else "bias"
        return f"{_CNN}/CNN_0/Conv_{m[1]}/{leaf}", "conv" if m[2] == "weight" else "plain"
    m = re.fullmatch(r"cnn_encoder\.cnn\.fc\.(weight|bias)", name)
    if m:
        return (f"{_CNN}/Dense_0/kernel", "fc") if m[1] == "weight" else (f"{_CNN}/Dense_0/bias", "plain")
    m = re.fullmatch(r"actor_heads\.(\d+)\.(weight|bias)", name)
    if m:
        return (f"actor_head_{m[1]}/kernel", "dense") if m[2] == "weight" else (f"actor_head_{m[1]}/bias", "plain")
    for src, dst in prefixes.items():
        if name.startswith(src):
            m = re.fullmatch(r"(layers|norms)\.(\d+)\.(weight|bias)", name[len(src) :])
            if m is None:
                break
            if m[1] == "layers":
                leaf, kind = ("kernel", "dense") if m[3] == "weight" else ("bias", "plain")
                return f"{dst}Dense_{m[2]}/{leaf}", kind
            return f"{dst}LayerNorm_{m[2]}/LayerNorm_0/{'scale' if m[3] == 'weight' else 'bias'}", "plain"
    raise KeyError(f"PPO state-dict key {name!r} has no flax counterpart")


def _fc_map_shape(flat: Mapping[str, Any], rows: int) -> Tuple[int, int, int]:
    """``(H, W, C)`` of NatureCNN's last map: C from the last conv, a
    square map."""
    convs = sorted(k for k in flat if re.fullmatch(rf"{_CNN}/CNN_0/Conv_\d+/kernel", k))
    c = int(np.shape(flat[convs[-1]])[-1]) if convs else 64
    side = int(round((rows // c) ** 0.5))
    if side * side * c != rows:
        raise ValueError(f"NatureCNN feature Dense with {rows} input rows is not a square map of {c} channels")
    return side, side, c


def agent_from_flax(tree: Mapping[str, Any], prefixes: Mapping[str, str] = _PREFIXES) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``PPOAgent`` from a JAX ``PPOAgent`` param
    tree."""
    flat = _flatten(tree["params"] if "params" in tree else tree)
    out: Dict[str, torch.Tensor] = {}
    for path in list(flat):
        name, kind = _port_name(path, prefixes)
        a = np.asarray(flat[path], dtype=np.float32)
        if kind == "dense":
            a = a.T
        elif kind == "conv":
            a = a.transpose(3, 2, 0, 1)
        elif kind == "fc":
            h, w, c = _fc_map_shape(flat, a.shape[0])
            a = a.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c, -1).T
        out[name] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return out


def agent_to_flax(sd: Mapping[str, Any], prefixes: Mapping[str, str] = _PREFIXES) -> Dict[str, Any]:
    """The JAX ``PPOAgent`` param tree (``{"params": ...}``) of a port
    state dict (or a tree keyed as one, such as Adam's moments), as numpy
    in each tensor's dtype (bf16 as float32)."""
    flat: Dict[str, np.ndarray] = {}
    for name, v in sd.items():
        t = torch.as_tensor(v).detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        path, kind = _flax_path(name, prefixes)
        if kind == "dense":
            a = a.T
        elif kind == "conv":
            a = a.transpose(2, 3, 1, 0)
        elif kind == "fc":
            c, h, w = _sd_map_shape(sd, a.shape[1])
            a = a.T.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(h * w * c, -1)
        flat[path] = np.ascontiguousarray(a)
    return {"params": _unflatten(flat)}


def _sd_map_shape(sd: Mapping[str, Any], cols: int) -> Tuple[int, int, int]:
    """``(C, H, W)`` of NatureCNN's last map from a state dict."""
    convs = sorted(k for k in sd if re.fullmatch(r"cnn_encoder\.cnn\.convs\.\d+\.weight", k))
    c = int(sd[convs[-1]].shape[0]) if convs else 64
    side = int(round((cols // c) ** 0.5))
    return c, side, side


def _port_name(path: str, prefixes: Mapping[str, str] = _PREFIXES) -> Tuple[str, str]:
    """(port key, kind) of a flax path: the inverse of :func:`_flax_path`."""
    m = re.fullmatch(rf"{_CNN}/CNN_0/Conv_(\d+)/(kernel|bias)", path)
    if m:
        return f"cnn_encoder.cnn.convs.{m[1]}.{'weight' if m[2] == 'kernel' else 'bias'}", "conv" if m[2] == "kernel" else "plain"
    m = re.fullmatch(rf"{_CNN}/Dense_0/(kernel|bias)", path)
    if m:
        return ("cnn_encoder.cnn.fc.weight", "fc") if m[1] == "kernel" else ("cnn_encoder.cnn.fc.bias", "plain")
    m = re.fullmatch(r"actor_head_(\d+)/(kernel|bias)", path)
    if m:
        return (f"actor_heads.{m[1]}.weight", "dense") if m[2] == "kernel" else (f"actor_heads.{m[1]}.bias", "plain")
    for dst, src in prefixes.items():
        if path.startswith(src):
            rest = path[len(src) :]
            m = re.fullmatch(r"Dense_(\d+)/(kernel|bias)", rest)
            if m:
                return (f"{dst}layers.{m[1]}.weight", "dense") if m[2] == "kernel" else (f"{dst}layers.{m[1]}.bias", "plain")
            m = re.fullmatch(r"LayerNorm_(\d+)/LayerNorm_0/(scale|bias)", rest)
            if m:
                return f"{dst}norms.{m[1]}.{'weight' if m[2] == 'scale' else 'bias'}", "plain"
    raise KeyError(f"flax PPO param {path!r} has no port counterpart")
