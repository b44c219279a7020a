"""Flax -> port weight conversion for Dreamer-V3.

The JAX package's param trees (``{"params": {...}}``, nested dicts of numpy
arrays, as its checkpoints hold them) become state dicts of this package's
``WorldModel``, ``Actor`` and ``Critic``. The same functions carry gradient
trees across, which share the params' layout. The layout rules:

- a flax ``Dense`` kernel is ``[in, out]`` and becomes ``nn.Linear.weight``
  ``[out, in]``; the recurrent model keeps ``[in, out]``, which the fused
  CUDA step reads as it is;
- a flax conv kernel is HWIO and becomes OIHW (the encoder convs have no
  bias);
- a flax ``ConvTranspose`` (``transpose_kernel=False``) correlates the
  stride-dilated input with its HWIO kernel as stored, where
  ``nn.ConvTranspose2d`` correlates it with the spatially flipped kernel
  held as ``[in, out, kH, kW]``: the kernel is flipped in kH and kW and
  moved to ``[in, out, kH, kW]``;
- the repo's LayerNorm wrapper nests a flax ``LayerNorm``, so its params sit
  one level down, at ``.../LayerNorm_i/LayerNorm_0/{scale,bias}``;
- an ``_LNMLP`` is a flat ``Dense_i``/``LayerNorm_i`` list; an
  ``nn.Sequential`` head is ``layers_0`` (the ``_LNMLP``) and ``layers_1``
  (the output ``Dense``).

Every leaf of a param tree is converted; a leaf with no port counterpart
raises. ``world_model_to_flax``, ``actor_to_flax`` and ``critic_to_flax``
go the other way, for checkpoints in the JAX layout: a state dict (or any
tree keyed as one, such as Adam's moments) becomes the JAX param tree, and
a key with no flax counterpart raises. ``adam_to_optax`` and
``adam_from_optax`` carry an optimizer's state across in optax's chain
nesting, ``rmsprop_to_optax`` and ``rmsprop_from_optax`` RMSProp's, and
``optimizer_to_optax``/``optimizer_from_optax`` pick by the optimizer.

``shard_recurrent`` cuts the recurrent model's params into one model rank's
arguments of the model-sharded step (``pallas_gru.py:393-395`` and the
``in_specs`` at :427-441).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sheeprl_tpu_torch.ops.optim import Adam, Optimizer, RMSProp
from sheeprl_tpu_torch.utils.checkpoint import (
    EmptyState,
    ScaleByAdamState,
    ScaleByRmsState,
    ScaleByRStdDevState,
    ScaleByScheduleState,
    TraceState,
)

def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _params(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return _flatten(tree["params"] if "params" in tree else tree)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Converter:
    def __init__(self, flat: Dict[str, np.ndarray]) -> None:
        self.flat = flat
        self.out: Dict[str, torch.Tensor] = {}

    def has(self, src: str) -> bool:
        return src in self.flat

    def take(self, src: str, dst: str, transpose: Tuple[int, ...] = ()) -> None:
        a = self.flat.pop(src)
        self.out[dst] = _t(a.transpose(transpose) if transpose else a)

    def dense(self, src: str, dst: str) -> None:
        self.take(f"{src}/kernel", f"{dst}.weight", (1, 0))
        if self.has(f"{src}/bias"):
            self.take(f"{src}/bias", f"{dst}.bias")

    def layer_norm(self, src: str, dst: str) -> None:
        self.take(f"{src}/LayerNorm_0/scale", f"{dst}.weight")
        self.take(f"{src}/LayerNorm_0/bias", f"{dst}.bias")

    def lnmlp(self, src: str, dst: str) -> None:
        i = 0
        while self.has(f"{src}/Dense_{i}/kernel"):
            self.dense(f"{src}/Dense_{i}", f"{dst}.linears.{i}")
            self.layer_norm(f"{src}/LayerNorm_{i}", f"{dst}.norms.{i}")
            i += 1

    def conv_transpose(self, src: str, dst: str) -> None:
        a = self.flat.pop(f"{src}/kernel")
        self.out[f"{dst}.weight"] = _t(np.flip(a, (0, 1)).transpose(2, 3, 0, 1))
        if self.has(f"{src}/bias"):
            self.take(f"{src}/bias", f"{dst}.bias")

    def cnn_decoder(self, src: str, dst: str) -> None:
        """``CNNDecoder``: ``Dense_0``, then ``ConvTranspose_i`` with
        ``LayerNorm_i`` but for the last (plain, with bias)."""
        self.dense(f"{src}Dense_0", f"{dst}linear")
        n = 0
        while self.has(f"{src}ConvTranspose_{n}/kernel"):
            n += 1
        for i in range(n - 1):
            self.conv_transpose(f"{src}ConvTranspose_{i}", f"{dst}deconvs.{i}")
            self.layer_norm(f"{src}LayerNorm_{i}", f"{dst}norms.{i}")
        self.conv_transpose(f"{src}ConvTranspose_{n - 1}", f"{dst}out")

    def head(self, src: str, dst: str) -> None:
        """An ``nn.Sequential`` of an ``_LNMLP`` and its output ``Dense``."""
        self.lnmlp(f"{src}/layers_0", f"{dst}.0")
        self.dense(f"{src}/layers_1", f"{dst}.1")


def world_model_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``WorldModel`` from a JAX ``WorldModel``
    param tree."""
    c = _Converter(_params(tree))
    i = 0
    while c.has(f"cnn_encoder/Conv_{i}/kernel"):
        c.take(f"cnn_encoder/Conv_{i}/kernel", f"cnn_encoder.convs.{i}.weight", (3, 2, 0, 1))
        c.layer_norm(f"cnn_encoder/LayerNorm_{i}", f"cnn_encoder.norms.{i}")
        i += 1
    c.lnmlp("mlp_encoder/_LNMLP_0", "mlp_encoder.mlp")
    rec = "recurrent_model"
    c.take(f"{rec}/Dense_0/kernel", "recurrent_model.in_kernel")
    c.take(f"{rec}/Dense_0/bias", "recurrent_model.in_bias")
    c.layer_norm(f"{rec}/LayerNorm_0", "recurrent_model.in_norm")
    c.take(f"{rec}/LayerNormGRUCell_0/Dense_0/kernel", "recurrent_model.gru.kernel")
    c.layer_norm(f"{rec}/LayerNormGRUCell_0/LayerNorm_0", "recurrent_model.gru.norm")
    for head in ("representation_model", "transition_model", "reward_model", "continue_model"):
        c.head(head, head)
    if c.has("cnn_decoder/Dense_0/kernel"):
        c.cnn_decoder("cnn_decoder/", "cnn_decoder.")
    c.lnmlp("mlp_decoder/_LNMLP_0", "mlp_decoder.mlp")
    for k in sorted({p.split("/")[1] for p in c.flat if p.startswith("mlp_decoder/head_")}):
        c.dense(f"mlp_decoder/{k}", f"mlp_decoder.heads.{k[len('head_'):]}")
    if c.has("initial_recurrent_state"):
        c.take("initial_recurrent_state", "initial_recurrent_state")
    if c.flat:
        raise KeyError(f"world-model leaves with no port counterpart: {sorted(c.flat)}")
    return c.out


def actor_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``Actor`` from a JAX ``Actor`` param tree."""
    c = _Converter(_params(tree))
    c.lnmlp("_LNMLP_0", "mlp")
    i = 0
    while c.has(f"head_{i}/kernel"):
        c.dense(f"head_{i}", f"heads.{i}")
        i += 1
    if c.flat:
        raise KeyError(f"actor leaves with no port counterpart: {sorted(c.flat)}")
    return c.out


def cnn_decoder_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``CNNDecoder`` from a JAX ``CNNDecoder``
    param tree."""
    c = _Converter(_params(tree))
    c.cnn_decoder("", "")
    if c.flat:
        raise KeyError(f"decoder leaves with no port counterpart: {sorted(c.flat)}")
    return c.out


def critic_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``Critic`` from a JAX critic param tree
    (``make_critic``: ``_LNMLP_0`` and the head ``Dense_0``)."""
    c = _Converter(_params(tree))
    c.lnmlp("_LNMLP_0", "mlp")
    c.dense("Dense_0", "head")
    if c.flat:
        raise KeyError(f"critic leaves with no port counterpart: {sorted(c.flat)}")
    return c.out


# --------------------------------------------------------------------------- #
# port -> flax
# --------------------------------------------------------------------------- #

_LEAF = {"weight": "kernel", "bias": "bias"}
_LN_LEAF = {"weight": "scale", "bias": "bias"}
_HEADS = ("representation_model", "transition_model", "reward_model", "continue_model")
Rule = Tuple[str, str]  # (flax path, layout: copy | dense | conv | deconv)


def _lnmlp_path(rest: str, prefix: str) -> Optional[Rule]:
    """An ``_LNMLP``'s ``linears.i.*`` / ``norms.i.*`` under flax ``prefix``."""
    m = re.fullmatch(r"linears\.(\d+)\.(weight|bias)", rest)
    if m:
        return f"{prefix}/Dense_{m[1]}/{_LEAF[m[2]]}", "dense" if m[2] == "weight" else "copy"
    m = re.fullmatch(r"norms\.(\d+)\.(weight|bias)", rest)
    if m:
        return f"{prefix}/LayerNorm_{m[1]}/LayerNorm_0/{_LN_LEAF[m[2]]}", "copy"
    return None


def _dense_path(leaf: str, prefix: str) -> Rule:
    return f"{prefix}/{_LEAF[leaf]}", "dense" if leaf == "weight" else "copy"


def _world_model_path(name: str, n_deconvs: int) -> Optional[Rule]:
    if name == "initial_recurrent_state":
        return name, "copy"
    m = re.fullmatch(r"cnn_encoder\.convs\.(\d+)\.weight", name)
    if m:
        return f"cnn_encoder/Conv_{m[1]}/kernel", "conv"
    m = re.fullmatch(r"cnn_encoder\.norms\.(\d+)\.(weight|bias)", name)
    if m:
        return f"cnn_encoder/LayerNorm_{m[1]}/LayerNorm_0/{_LN_LEAF[m[2]]}", "copy"
    rec = {
        "recurrent_model.in_kernel": "recurrent_model/Dense_0/kernel",
        "recurrent_model.in_bias": "recurrent_model/Dense_0/bias",
        "recurrent_model.in_norm.weight": "recurrent_model/LayerNorm_0/LayerNorm_0/scale",
        "recurrent_model.in_norm.bias": "recurrent_model/LayerNorm_0/LayerNorm_0/bias",
        "recurrent_model.gru.kernel": "recurrent_model/LayerNormGRUCell_0/Dense_0/kernel",
        "recurrent_model.gru.norm.weight": "recurrent_model/LayerNormGRUCell_0/LayerNorm_0/LayerNorm_0/scale",
        "recurrent_model.gru.norm.bias": "recurrent_model/LayerNormGRUCell_0/LayerNorm_0/LayerNorm_0/bias",
    }
    if name in rec:
        return rec[name], "copy"
    for enc in ("mlp_encoder", "mlp_decoder"):
        if name.startswith(f"{enc}.mlp."):
            return _lnmlp_path(name[len(enc) + 5 :], f"{enc}/_LNMLP_0")
    m = re.fullmatch(r"mlp_decoder\.heads\.(.+)\.(weight|bias)", name)
    if m:
        return _dense_path(m[2], f"mlp_decoder/head_{m[1]}")
    for head in _HEADS:
        if name.startswith(f"{head}.0."):
            return _lnmlp_path(name[len(head) + 3 :], f"{head}/layers_0")
        m = re.fullmatch(rf"{head}\.1\.(weight|bias)", name)
        if m:
            return _dense_path(m[1], f"{head}/layers_1")
    m = re.fullmatch(r"cnn_decoder\.linear\.(weight|bias)", name)
    if m:
        return _dense_path(m[1], "cnn_decoder/Dense_0")
    m = re.fullmatch(r"cnn_decoder\.norms\.(\d+)\.(weight|bias)", name)
    if m:
        return f"cnn_decoder/LayerNorm_{m[1]}/LayerNorm_0/{_LN_LEAF[m[2]]}", "copy"
    m = re.fullmatch(r"cnn_decoder\.(deconvs\.(\d+)|out)\.(weight|bias)", name)
    if m:
        i = n_deconvs if m[1] == "out" else int(m[2])
        return f"cnn_decoder/ConvTranspose_{i}/{_LEAF[m[3]]}", "deconv" if m[3] == "weight" else "copy"
    return None


def _to_flax(sd: Mapping[str, Any], path_of: Callable[[str], Optional[Rule]], what: str) -> Dict[str, Any]:
    """``{"params": nested}`` of numpy fp32 leaves from a port-keyed tree."""
    tree: Dict[str, Any] = {}
    for name, v in sd.items():
        rule = path_of(name)
        if rule is None:
            raise KeyError(f"{what} key with no flax counterpart: {name!r}")
        path, layout = rule
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.float32)
        if layout == "dense":
            a = a.T
        elif layout == "conv":  # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        elif layout == "deconv":  # [in, out, kH, kW] -> HWIO, flipped back in kH, kW
            a = np.flip(a.transpose(2, 3, 0, 1), (0, 1))
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def world_model_to_flax(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX ``WorldModel`` param tree of a port ``WorldModel`` state
    dict (or of a tree keyed as one)."""
    n_deconvs = len([k for k in sd if re.fullmatch(r"cnn_decoder\.deconvs\.\d+\.weight", k)])
    return _to_flax(sd, lambda n: _world_model_path(n, n_deconvs), "world-model")


def actor_to_flax(sd: Mapping[str, Any]) -> Dict[str, Any]:
    def path_of(name: str) -> Optional[Rule]:
        if name.startswith("mlp."):
            return _lnmlp_path(name[4:], "_LNMLP_0")
        m = re.fullmatch(r"heads\.(\d+)\.(weight|bias)", name)
        return _dense_path(m[2], f"head_{m[1]}") if m else None

    return _to_flax(sd, path_of, "actor")


def critic_to_flax(sd: Mapping[str, Any]) -> Dict[str, Any]:
    def path_of(name: str) -> Optional[Rule]:
        if name.startswith("mlp."):
            return _lnmlp_path(name[4:], "_LNMLP_0")
        m = re.fullmatch(r"head\.(weight|bias)", name)
        return _dense_path(m[1], "Dense_0") if m else None

    return _to_flax(sd, path_of, "critic")


def _adam_nesting(opt: Adam, adam_state: ScaleByAdamState) -> Any:
    """optax's state nesting of ``sheeprl_tpu/ops/optim.py::adam``: adam is
    ``chain(scale_by_adam, scale_by_learning_rate)`` (adamw adds
    ``add_decayed_weights`` between them), behind ``chain(
    clip_by_global_norm, .)`` when clipping; every state but Adam's and a
    scheduled learning rate's count is empty."""
    lr_state = ScaleByScheduleState(adam_state.count) if opt.schedule_steps > 0 else EmptyState()
    inner = (adam_state, EmptyState(), lr_state) if opt.weight_decay else (adam_state, lr_state)
    return (EmptyState(), inner) if opt.max_grad_norm > 0 else inner


def _nesting(state: Any) -> Any:
    """The chain's shape: plain tuples kept, each record by its class name."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return tuple(_nesting(s) for s in state)
    return type(state).__name__


def adam_to_optax(opt: Adam, names: Sequence[str], to_flax: Callable[[Mapping[str, Any]], Any]) -> Any:
    """``opt``'s state in optax's nesting, ``mu`` and ``nu`` as flax trees
    (``names`` are the parameters' state-dict keys, in ``opt.params``'
    order; ``to_flax`` the model's converter)."""
    state = ScaleByAdamState(
        count=np.asarray(opt.count.item(), dtype=np.int32),
        mu=to_flax(dict(zip(names, opt.mu, strict=True))),
        nu=to_flax(dict(zip(names, opt.nu, strict=True))),
    )
    return _adam_nesting(opt, state)


@torch.no_grad()
def adam_from_optax(
    state: Any, opt: Adam, names: Sequence[str], from_flax: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]
) -> None:
    """Load an optax state (the JAX package's or the port's) into ``opt``,
    in place; raises unless it has ``opt``'s nesting."""
    want = _adam_nesting(opt, ScaleByAdamState(None, None, None))
    if _nesting(state) != _nesting(want):
        raise ValueError(f"optimizer state nesting {_nesting(state)} is not this optimizer's {_nesting(want)}")
    adam = state[1][0] if opt.max_grad_norm > 0 else state[0]
    mu, nu = from_flax(adam.mu), from_flax(adam.nu)
    for i, name in enumerate(names):
        opt.mu[i].copy_(mu[name])
        opt.nu[i].copy_(nu[name])
    opt.count.fill_(int(np.asarray(adam.count)))


def _rmsprop_nesting(opt: RMSProp, scale_state: Any, trace: Any) -> Any:
    """optax's state nesting of ``sheeprl_tpu/ops/optim.py::rmsprop`` (and
    ``rmsprop_tf``): ``chain(scale_by_rms or scale_by_stddev,
    scale_by_learning_rate, trace or identity)``, behind ``chain(
    add_decayed_weights, .)`` with weight decay and ``chain(
    clip_by_global_norm, .)`` when clipping."""
    lr_state = ScaleByScheduleState(np.asarray(opt.count.item(), dtype=np.int32)) if opt.schedule_steps > 0 else EmptyState()
    state: Any = (scale_state, lr_state, TraceState(trace) if opt.trace is not None else EmptyState())
    if opt.weight_decay:
        state = (EmptyState(), state)
    return (EmptyState(), state) if opt.max_grad_norm > 0 else state


def _rmsprop_core(opt: RMSProp, state: Any) -> Any:
    """The inner ``rmsprop`` chain of an optax state with ``opt``'s nesting."""
    if opt.max_grad_norm > 0:
        state = state[1]
    return state[1] if opt.weight_decay else state


def rmsprop_to_optax(opt: RMSProp, names: Sequence[str], to_flax: Callable[[Mapping[str, Any]], Any]) -> Any:
    """``opt``'s state in optax's nesting (``nu``, ``mu`` and ``trace`` as
    flax trees), as :func:`adam_to_optax` builds Adam's."""
    tree = lambda ts: to_flax(dict(zip(names, ts, strict=True)))  # noqa: E731
    nu = tree(opt.nu)
    scale = ScaleByRStdDevState(mu=tree(opt.mu), nu=nu) if opt.mu is not None else ScaleByRmsState(nu=nu)
    return _rmsprop_nesting(opt, scale, tree(opt.trace) if opt.trace is not None else None)


@torch.no_grad()
def rmsprop_from_optax(
    state: Any, opt: RMSProp, names: Sequence[str], from_flax: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]
) -> None:
    """Load an optax RMSProp state (the JAX package's or the port's) into
    ``opt``, in place; raises unless it has ``opt``'s nesting."""
    scale = ScaleByRStdDevState(None, None) if opt.mu is not None else ScaleByRmsState(None)
    want = _rmsprop_nesting(opt, scale, None)
    if _nesting(state) != _nesting(want):
        raise ValueError(f"optimizer state nesting {_nesting(state)} is not this optimizer's {_nesting(want)}")
    core = _rmsprop_core(opt, state)
    pairs = [(opt.nu, core[0].nu)]
    if opt.mu is not None:
        pairs.append((opt.mu, core[0].mu))
    if opt.trace is not None:
        pairs.append((opt.trace, core[2].trace))
    for tensors, tree in pairs:
        flat = from_flax(tree)
        for t, name in zip(tensors, names):
            t.copy_(flat[name])
    if opt.schedule_steps > 0:
        opt.count.fill_(int(np.asarray(core[1].count)))


def optimizer_to_optax(opt: Optimizer, names: Sequence[str], to_flax: Callable[[Mapping[str, Any]], Any]) -> Any:
    """:func:`adam_to_optax` or :func:`rmsprop_to_optax`, by ``opt``'s type."""
    return rmsprop_to_optax(opt, names, to_flax) if isinstance(opt, RMSProp) else adam_to_optax(opt, names, to_flax)


def optimizer_from_optax(
    state: Any, opt: Optimizer, names: Sequence[str], from_flax: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]
) -> None:
    """:func:`adam_from_optax` or :func:`rmsprop_from_optax`, by ``opt``'s
    type."""
    if isinstance(opt, RMSProp):
        rmsprop_from_optax(state, opt, names, from_flax)
    else:
        adam_from_optax(state, opt, names, from_flax)


# the recurrent model's params in the fused step's order (w1, b1, g1, be1,
# w2, g2, be2), as leaves of its flax subtree
RECURRENT_LEAVES = (
    "Dense_0/kernel",
    "Dense_0/bias",
    "LayerNorm_0/LayerNorm_0/scale",
    "LayerNorm_0/LayerNorm_0/bias",
    "LayerNormGRUCell_0/Dense_0/kernel",
    "LayerNormGRUCell_0/LayerNorm_0/LayerNorm_0/scale",
    "LayerNormGRUCell_0/LayerNorm_0/LayerNorm_0/bias",
)


def shard_recurrent(
    src: Union[Mapping[str, Any], Sequence[Any]],
    mp: int,
    idx: int,
    dtype: Optional[torch.dtype] = None,
) -> List[torch.Tensor]:
    """One model rank's arguments of ``ops.fused_gru.sharded_recurrent_step``.

    ``src`` is either the recurrent model's flax subtree (or a world-model
    tree holding ``recurrent_model``), giving ``[w1, b1, g1, be1, w2s, g2s,
    be2s]``, or the step's nine arrays ``x, h, w1, b1, g1, be1, w2, g2, be2``,
    giving the nine arguments. The last three are cut: ``W2 [H+D, 3H]`` is
    viewed gate-major as ``[H+D, 3, H]``, columns ``idx*H/mp : (idx+1)*H/mp``
    of each gate are kept and reshaped to ``[H+D, 3H/mp]``; ``g2, be2 [3H]``
    alike. The rest stay whole (replicated). ``dtype`` is the storage type
    of the W2 slice (``torch.bfloat16`` allowed); every other tensor is
    fp32. Raises ``ValueError`` unless ``H % mp == 0`` and ``0 <= idx < mp``.
    """
    if isinstance(src, Mapping):
        flat = _params(src)
        prefix = "recurrent_model/" if f"recurrent_model/{RECURRENT_LEAVES[0]}" in flat else ""
        arrays = [flat[prefix + leaf] for leaf in RECURRENT_LEAVES]
    else:
        arrays = list(src)
        if len(arrays) != 9:
            raise ValueError(f"shard_recurrent: expected the step's nine arrays, got {len(arrays)}")
    *whole, w2, g2, be2 = (np.asarray(a, dtype=np.float32) for a in arrays)
    rows, cols = w2.shape
    hidden = cols // 3
    if cols != 3 * hidden or hidden % mp != 0:
        raise ValueError(f"shard_recurrent: hidden ({hidden}, from W2 {w2.shape}) must divide by mp ({mp})")
    if not 0 <= idx < mp:
        raise ValueError(f"shard_recurrent: idx {idx} is not a model rank of mp={mp}")
    hs = hidden // mp
    cut = slice(idx * hs, (idx + 1) * hs)
    w2s = w2.reshape(rows, 3, hidden)[:, :, cut].reshape(rows, 3 * hs)
    g2s, be2s = (v.reshape(3, hidden)[:, cut].reshape(3 * hs) for v in (g2, be2))
    out = [_t(a) for a in (*whole, w2s, g2s, be2s)]
    if dtype is not None:
        out[-3] = out[-3].to(dtype)
    return out
