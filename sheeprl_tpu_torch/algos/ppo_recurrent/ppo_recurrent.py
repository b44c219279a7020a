"""Recurrent PPO training (port of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``: ``build_sequences``
:79-131, ``make_local_train`` :134-237, the fused gate :359-402 and ``main``
:240-781), on one device.

The host loop (``algo.fused_rollout=False``) steps the player on the host
envs, storing each step's state *before* it (``prev_hx``, ``prev_cx``,
``prev_actions``); the truncation bootstrap runs the critic on the
post-step state and the step's actions; ``prev_actions = (1 - done) *
actions`` and, with ``reset_recurrent_state_on_done``, done envs restart
the LSTM from zeros. After the rollout the episodes are cut into chunks of
at most ``per_rank_sequence_length`` steps, each padded to that length, and
the chunk count to a multiple of ``per_rank_num_batches``
(:func:`build_sequences`); the update is ``update_epochs`` epochs of
``per_rank_num_batches`` minibatches of whole sequences, with the losses
masked to the valid steps.

On the card the critic on the last state, GAE, the gather of the
sequences from the rollout and the update are one ``CapturedStep``. The
chunk count changes with the episode ends, so there is one capture for
each padded count (the JAX package compiles one program for each, :9-11);
``main`` reports how many it made. The padding is the JAX package's: more
would change which sequences share a minibatch.

With ``algo.fused_rollout=True`` and a twin env (PPO's gate plus the three
recurrent ``fused_fallback`` reasons) the rollout, GAE, fixed windows and
the update are one ``ops/rollout_scan.py`` recurrent superstep, one replay
an update.

Checkpoints hold the JAX layout, as PPO's do; a run resumes from the port's
or the JAX package's. NaN rollback, the crash guard and the preemption exit
are wired as in PPO, and a test episode runs at the end.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.convert import optimizer_from_optax, optimizer_to_optax
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _clock, _elapsed, restore_generator, stream_seed
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import (
    METRIC_ORDER,
    opt_state_tensors,
    resolve_fused_rollout_spec,
    scenario_variant_cfg,
    start_run,
)
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import (
    RecurrentPPOAgent,
    RecurrentPPOPlayer,
    build_agent,
    evaluate_actions,
    evaluate_actions_resettable,
    recurrent_rollout_step,
)
from sheeprl_tpu_torch.algos.ppo_recurrent.convert import agent_from_flax, agent_to_flax
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import AGGREGATOR_KEYS, prepare_obs, test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import Box, action_dims
from sheeprl_tpu_torch.envs.variants import ScenarioFamily, make_scenario_family, sample_scenario_matrix
from sheeprl_tpu_torch.obs.heartbeat import log_sps_and_heartbeat
from sheeprl_tpu_torch.obs.telemetry import (
    get_telemetry,
    telemetry_advance,
    telemetry_mark_warm,
    telemetry_register_flops,
    telemetry_run_metrics,
    telemetry_train_window,
)
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.ops.math import gae
from sheeprl_tpu_torch.ops.optim import Optimizer, build_optimizer
from sheeprl_tpu_torch.ops.rollout_scan import (
    ENV_STREAM_SALT,
    init_recurrent_env_carry,
    make_recurrent_onpolicy_superstep_fn,
)
from sheeprl_tpu_torch.ops.superstep import fused_fallback, reset_fused_fallback_warnings
from sheeprl_tpu_torch.parallel.fabric import place_player, resolve_player_device
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.prealloc import RolloutStore
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay

# the rollout keys the host path's sequences carry besides the observations
SEQUENCE_KEYS = ("actions", "logprobs", "values", "returns", "advantages", "prev_actions")


class SequenceLayout(NamedTuple):
    """Where each padded sequence step comes from in a ``[T, E]`` rollout:
    ``index [L, N]`` into the flattened ``T * E`` steps (``t * E + e``; 0 on
    padding), ``mask [L, N, 1]`` (1 on valid steps), ``start [N]`` (the
    flat index of each chunk's first step; 0 for a padding sequence) and
    ``valid [N, 1]`` (1 for a chunk, 0 for a padding sequence)."""

    index: np.ndarray
    mask: np.ndarray
    start: np.ndarray
    valid: np.ndarray


def sequence_layout(dones: np.ndarray, seq_len: int, pad_multiple: int) -> SequenceLayout:
    """The episode split of JAX ``build_sequences`` (:79-131) from the
    rollout's ``dones [T, E]``: for each env in order, its episodes (a
    done step ends one, the rollout's end the last) cut into chunks of at
    most ``seq_len`` steps, the chunk count padded up to a multiple of
    ``pad_multiple``."""
    t_len, num_envs = dones.shape[:2]
    chunks: List[Tuple[int, int, int]] = []  # (env, first step, length)
    for e in range(num_envs):
        ends = np.nonzero(dones[:, e].reshape(t_len))[0].tolist() + [t_len - 1]
        start = 0
        for end in ends:
            stop = min(end + 1, t_len)
            if stop <= start:
                continue
            for i in range(start, stop, seq_len):
                chunks.append((e, i, min(i + seq_len, stop) - i))
            start = stop
    n_pad = -(-len(chunks) // pad_multiple) * pad_multiple
    index = np.zeros((seq_len, n_pad), np.int64)
    mask = np.zeros((seq_len, n_pad, 1), np.float32)
    start = np.zeros(n_pad, np.int64)
    valid = np.zeros((n_pad, 1), np.float32)
    for j, (e, i, n) in enumerate(chunks):
        index[:n, j] = (i + np.arange(n)) * num_envs + e
        mask[:n, j] = 1.0
        start[j] = i * num_envs + e
        valid[j] = 1.0
    return SequenceLayout(index, mask, start, valid)


def build_sequences(
    local_data: Mapping[str, np.ndarray], train_keys: Sequence[str], seq_len: int, num_envs: int, pad_multiple: int
) -> Dict[str, np.ndarray]:
    """JAX ``build_sequences`` in numpy: ``train_keys`` of the ``[T, E,
    ...]`` rollout as ``[seq_len, N_pad, ...]`` chunks (zeros on padding),
    the ``mask`` of valid steps and the chunk-initial states ``hx0``/``cx0
    [N_pad, H]`` from the stored ``prev_hx``/``prev_cx``. ``num_envs`` is
    the JAX signature's: the rollout's shape gives it."""
    layout = sequence_layout(np.asarray(local_data["dones"])[..., 0], seq_len, pad_multiple)
    valid = layout.mask[..., 0] > 0
    out: Dict[str, np.ndarray] = {}
    for k in train_keys:
        v = np.asarray(local_data[k])
        g = v.reshape(-1, *v.shape[2:])[layout.index]
        out[k] = np.where(valid.reshape(valid.shape + (1,) * (g.ndim - 2)), g, np.zeros((), v.dtype))
    out["mask"] = layout.mask
    for k, src in (("hx0", "prev_hx"), ("cx0", "prev_cx")):
        v = np.asarray(local_data[src], np.float32)
        out[k] = v.reshape(-1, v.shape[-1])[layout.start] * layout.valid
    return out


def _gather(x: torch.Tensor, index: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x [T, E, ...]`` gathered to ``[L, N, ...]`` by a layout's index,
    zeros where ``mask`` is 0."""
    g = x.reshape(-1, *x.shape[2:])[index]
    keep = mask.reshape(*mask.shape[:2], *(1,) * (g.ndim - 2)) > 0
    return torch.where(keep, g, torch.zeros((), dtype=g.dtype, device=g.device))


def make_local_train(
    agent: RecurrentPPOAgent,
    opt: Optimizer,
    cfg: Mapping[str, Any],
    obs_keys: Sequence[str],
    generator: Optional[torch.Generator],
    sequence_dones: bool = False,
) -> Callable[..., torch.Tensor]:
    """The masked sequence update (JAX :134-237): ``local_train(data, hx0,
    cx0, coefs, perms=None) -> metrics [3]`` over ``[L, N, ...]`` sequences
    with their ``mask``, the agent and ``opt`` updated in place. Each of
    ``update_epochs`` epochs draws a permutation of the N sequences
    (argsort of ``torch.rand`` from ``generator``, or ``perms [epochs,
    N]``) and takes ``per_rank_num_batches`` minibatches of ``N //
    per_rank_num_batches`` sequences. The policy and value terms are means
    over the mask; the entropy term is a sum, over the mask's sum with
    ``loss_reduction: mean``; normalised advantages take the masked mean
    and the masked variance over ``mask.sum() - 1``. ``sequence_dones``
    (the fused windows) replays the rollout's resets at the stored
    ``dones`` (``evaluate_actions_resettable``)."""
    algo = cfg["algo"]
    update_epochs = int(algo["update_epochs"])
    num_batches = max(1, int(algo["per_rank_num_batches"]))
    vf_coef = float(algo["vf_coef"])
    clip_vloss = bool(algo["clip_vloss"])
    normalize_adv = bool(algo["normalize_advantages"])
    reduction = str(algo["loss_reduction"])
    reset_on_done = bool(algo["reset_recurrent_state_on_done"])
    params = list(agent.parameters())

    def minibatch_step(batch: Dict[str, torch.Tensor], h0: torch.Tensor, c0: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
        clip_coef, ent_coef = coefs[0], coefs[1]
        with torch.enable_grad():
            obs = {k: batch[k] for k in obs_keys}
            if sequence_dones:
                logprobs, entropy, values = evaluate_actions_resettable(
                    agent, obs, batch["prev_actions"], h0, c0, batch["actions"], batch["dones"], reset_on_done=reset_on_done
                )
            else:
                logprobs, entropy, values = evaluate_actions(agent, obs, batch["prev_actions"], h0, c0, batch["actions"])
            mask = batch["mask"]
            msum = mask.sum() + 1e-8
            adv = batch["advantages"]
            if normalize_adv:
                mean = (adv * mask).sum() / msum
                var = ((adv - mean).square() * mask).sum() / torch.clamp(msum - 1, min=1.0)
                adv = (adv - mean) / (var.sqrt() + 1e-8)
            pg = (policy_loss(logprobs, batch["logprobs"], adv, clip_coef, "none") * mask).sum() / msum
            v = (value_loss(values, batch["values"], batch["returns"], clip_coef, clip_vloss, "none") * mask).sum() / msum
            ent = (entropy_loss(entropy, "none") * mask).sum()
            if reduction == "mean":
                ent = ent / msum
            grads = torch.autograd.grad(pg + vf_coef * v + ent_coef * ent, params)
        opt.step(grads)
        return torch.stack([pg, v, ent]).detach()

    def local_train(
        data: Dict[str, torch.Tensor], hx0: torch.Tensor, cx0: torch.Tensor, coefs: torch.Tensor, perms: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        n_local = data["mask"].shape[1]
        bs = n_local // num_batches
        metrics = []
        for epoch in range(update_epochs):
            if perms is None:
                perm = torch.rand(n_local, generator=generator, device=coefs.device).argsort()
            else:
                perm = perms[epoch].to(coefs.device)
            perm = perm[: num_batches * bs].view(num_batches, bs)
            for i in range(num_batches):
                idx = perm[i]
                batch = {k: v.index_select(1, idx) for k, v in data.items()}
                metrics.append(minibatch_step(batch, hx0.index_select(0, idx), cx0.index_select(0, idx), coefs))
        return torch.stack(metrics).mean(0)

    return local_train


def make_update_fn(
    agent: RecurrentPPOAgent, local_train: Callable[..., torch.Tensor], cfg: Mapping[str, Any], obs_keys: Sequence[str]
) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """One update of the host loop over its static inputs: the rollout's
    ``[T, E, ...]`` tensors, ``next/<key>``, ``next/prev_actions``,
    ``next/hx`` and ``next/cx`` (the state after the rollout), the
    sequence layout (``seq/index``, ``seq/mask``, ``seq/start``,
    ``seq/valid``) and ``coefs``: the critic on the next state, GAE
    (JAX :647-660), the sequences gathered from the rollout, then
    ``local_train``. Returns the metrics."""
    gamma, lmbda = float(cfg["algo"]["gamma"]), float(cfg["algo"]["gae_lambda"])

    def update(inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            next_obs = {k: inputs[f"next/{k}"][None] for k in obs_keys}
            next_values = agent(next_obs, inputs["next/prev_actions"][None], inputs["next/hx"], inputs["next/cx"])[1][0]
            returns, advantages = gae(inputs["rewards"], inputs["values"], inputs["dones"], next_values, gamma, lmbda)
            data = {k: inputs[k] for k in (*obs_keys, *SEQUENCE_KEYS) if k in inputs}
            data["returns"], data["advantages"] = returns, advantages
            index, mask = inputs["seq/index"], inputs["seq/mask"]
            seq = {k: _gather(v, index, mask) for k, v in data.items()}
            seq["mask"] = mask
            start, valid = inputs["seq/start"], inputs["seq/valid"]
            hx0 = inputs["prev_hx"].reshape(-1, inputs["prev_hx"].shape[-1])[start] * valid
            cx0 = inputs["prev_cx"].reshape(-1, inputs["prev_cx"].shape[-1])[start] * valid
        return local_train(seq, hx0, cx0, inputs["coefs"])

    return update


def collect_rollout(
    player: RecurrentPPOPlayer,
    envs: Any,
    buf: Any,
    next_obs: Dict[str, np.ndarray],
    state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    generator: Optional[torch.Generator],
    rollout_steps: int,
    gamma: float,
    cnn_keys: Sequence[str],
    reset_on_done: bool,
    on_episode: Optional[Callable[[int, float, int, int], None]] = None,
) -> Tuple[Dict[str, np.ndarray], Tuple[torch.Tensor, torch.Tensor, torch.Tensor], np.ndarray]:
    """The host loop's rollout (JAX :580-640): ``rollout_steps`` steps of
    the player on ``envs`` from ``state = (prev_actions, hx, cx)`` (device
    tensors) into ``buf``, the state before each step stored with it, the
    truncation bootstrap on the post-step state and this step's actions.
    Returns the observation and the state after the last step and the
    rollout's ``dones [T, E]`` on the host. ``on_episode(env, return,
    length, t)`` is called for each episode that ended at step ``t``."""
    agent = player.agent
    dev = player.device
    obs_keys = agent.cnn_keys + agent.mlp_keys
    num_envs = envs.num_envs
    act_shape = envs.single_action_space.shape
    one_head = not agent.is_continuous and len(agent.actions_dim) == 1
    prev_actions, hx, cx = state
    host_dones = np.zeros((rollout_steps, num_envs), np.float32)
    for t in range(rollout_steps):
        actions, real_actions, logprobs, values, new_hx, new_cx = player.rollout_actions(next_obs, prev_actions, hx, cx, generator)
        real = real_actions.cpu().numpy()
        obs, rewards, terminated, truncated, info = envs.step((real[..., 0] if one_head else real).reshape(num_envs, *act_shape))
        rewards = np.asarray(rewards, dtype=np.float32).reshape(num_envs, 1)
        truncated_envs = np.nonzero(truncated)[0]
        if len(truncated_envs) > 0 and "final_obs" in info:
            final = {k: np.stack([np.asarray(info["final_obs"][e][k]) for e in truncated_envs]) for k in obs_keys}
            final = prepare_obs(final, cnn_keys=cnn_keys, num_envs=len(truncated_envs))
            idx = torch.as_tensor(truncated_envs, device=dev)
            vals = player.get_values(final, actions[idx], new_hx[idx], new_cx[idx]).cpu().numpy()
            rewards[truncated_envs, 0] += gamma * vals.reshape(len(truncated_envs))
        dones = np.logical_or(terminated, truncated).reshape(num_envs, 1).astype(np.float32)
        step_values: Dict[str, Any] = {k: next_obs[k] for k in obs_keys}
        step_values.update(
            dones=dones, values=values, actions=actions, logprobs=logprobs, rewards=rewards, prev_hx=hx, prev_cx=cx, prev_actions=prev_actions
        )
        buf.put(t, step_values)
        host_dones[t] = dones[:, 0]
        keep = 1 - torch.from_numpy(dones).to(dev, non_blocking=True)
        prev_actions = keep * actions
        hx, cx = (keep * new_hx, keep * new_cx) if reset_on_done else (new_hx, new_cx)
        next_obs = prepare_obs(obs, cnn_keys=cnn_keys, num_envs=num_envs)
        if on_episode is not None and "final_info" in info:
            ep = info["final_info"].get("episode")
            if ep is not None:
                for i in np.nonzero(ep.get("_r", []))[0]:
                    on_episode(int(i), float(ep["r"][i]), int(ep["l"][i]), t)
    return next_obs, (prev_actions, hx, cx), host_dones


def resolve_recurrent_fused_spec(
    cfg: Mapping[str, Any],
    cnn_keys: Sequence[str],
    mlp_keys: Sequence[str],
    observation_space: Any,
    is_continuous: bool,
    is_multidiscrete: bool,
    actions_dim: Sequence[int],
    world_size: int = 1,
) -> Any:
    """PPO's gate, then the recurrent one (JAX :359-391): the rollout a
    multiple of the sequence length (``recurrent_seq``), the envs split over
    the devices (``env_shard``) and the window count over the minibatches
    (``sequence_batches``); each failure emits its ``fused_fallback`` and
    returns ``None``."""
    spec = resolve_fused_rollout_spec(cfg, cnn_keys, mlp_keys, observation_space, is_continuous, is_multidiscrete, actions_dim)
    if spec is None:
        return None
    algo = cfg["algo"]
    rollout_steps, seq_len = int(algo["rollout_steps"]), int(algo["per_rank_sequence_length"])
    num_envs, num_batches = int(cfg["env"]["num_envs"]), max(1, int(algo["per_rank_num_batches"]))
    if rollout_steps % seq_len != 0:
        fused_fallback(
            "recurrent_seq",
            f"algo.rollout_steps ({rollout_steps}) must be a multiple of per_rank_sequence_length ({seq_len}) "
            "for fixed-window fused sequences",
        )
        return None
    if num_envs % world_size != 0:
        fused_fallback("env_shard", f"env.num_envs ({num_envs}) must be divisible by the device count ({world_size})")
        return None
    n_seq = (rollout_steps // seq_len) * (num_envs // world_size)
    if n_seq % num_batches != 0:
        fused_fallback(
            "sequence_batches", f"per-shard sequence count ({n_seq}) must be divisible by per_rank_num_batches ({num_batches})"
        )
        return None
    return spec


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train recurrent PPO, called as the CLI calls it, ``main(fabric,
    cfg)``, or as ``main(cfg, device=...)`` (the CUDA card unless
    ``device="cpu"``), for ``algo.total_steps`` env steps (one update with
    ``dry_run``). Returns the run's counts, seconds, metrics, graph replays
    and the host path's captures."""
    fabric, cfg, state, log_dir, logger, callback, resil = start_run(fabric, cfg, device)
    if "minedojo" in str((cfg["env"].get("wrapper") or {}).get("_target_", "")).lower():
        raise ValueError(
            "MineDojo is not currently supported by PPO Recurrent agent, since it does not take "
            "into consideration the action masks provided by the environment."
        )
    ckpt_cfg = cfg["checkpoint"]
    dev = fabric.device
    algo = cfg["algo"]
    seed = int(cfg["seed"])

    envs = build_vector_env(cfg, 0, log_dir, "train")
    observation_space = envs.single_observation_space
    cnn_keys = list(algo["cnn_keys"]["encoder"])
    mlp_keys = list(algo["mlp_keys"]["encoder"])
    obs_keys = cnn_keys + mlp_keys
    if not obs_keys:
        raise RuntimeError(
            "You should specify at least one CNN key or MLP key from the cli: "
            "`algo.cnn_keys.encoder=[rgb]` or `algo.mlp_keys.encoder=[state]`"
        )
    actions_dim, is_continuous = action_dims(envs.single_action_space)
    is_multidiscrete = not is_continuous and len(actions_dim) > 1
    n_actions = int(sum(actions_dim))

    names, family_kwargs, ranges, variant_seed = scenario_variant_cfg(cfg)
    family = make_scenario_family(str(cfg["env"]["id"]), names, **family_kwargs) if names else None
    obs_widened = False
    if family is not None and not cnn_keys and len(mlp_keys) == 1:
        if tuple(observation_space[mlp_keys[0]].shape) != (family.obs_dim,):
            spaces_d = dict(observation_space.spaces)
            spaces_d[mlp_keys[0]] = Box(-np.inf, np.inf, (family.obs_dim,), np.float32)
            observation_space = type(observation_space)(spaces_d)
            obs_widened = True

    agent, player = build_agent(
        actions_dim, is_continuous, cfg, observation_space, agent_from_flax(state["agent"]) if state else None, device=dev
    )
    num_envs = int(cfg["env"]["num_envs"])
    rollout_steps = int(algo["rollout_steps"])
    seq_len = int(algo["per_rank_sequence_length"])
    policy_steps_per_update = num_envs * rollout_steps
    num_updates = int(algo["total_steps"]) // policy_steps_per_update if not cfg["dry_run"] else 1
    num_batches = max(1, int(algo["per_rank_num_batches"]))
    steps_per_update = int(algo["update_epochs"]) * num_batches
    opt = build_optimizer(
        list(agent.parameters()),
        algo["optimizer"],
        float(algo["max_grad_norm"] or 0.0),
        schedule_steps=num_updates * steps_per_update if algo["anneal_lr"] else 0,
    )
    param_names = [n for n, _ in agent.named_parameters()]
    if state is not None:
        optimizer_from_optax(state["opt_state"], opt, param_names, agent_from_flax)

    reset_fused_fallback_warnings()
    fused_spec = None
    if bool(algo.get("fused_rollout", False)):
        fused_spec = resolve_recurrent_fused_spec(
            cfg, cnn_keys, mlp_keys, observation_space, is_continuous, is_multidiscrete, actions_dim
        )
    if family is not None and fused_spec is None:
        raise RuntimeError(
            "env.variants requires the fused rollout path; set algo.fused_rollout=True (if it is set, the "
            "fused_fallback telemetry event names the gate that failed)"
        )

    # the player's device (JAX :324); recurrent PPO reads no train_device
    place_player(player, resolve_player_device(algo.get("player_device", "auto"), dev) or dev)
    train_gen = torch.Generator(device=dev).manual_seed(seed)
    player_gen = torch.Generator(device=dev if fused_spec is not None else player.device).manual_seed(stream_seed(seed, 1))
    env_gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, ENV_STREAM_SALT))
    start_update = int(state["update"]) + 1 if state is not None else 1
    policy_step = int(state["update"]) * policy_steps_per_update if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    if state is not None:
        restore_generator(train_gen, state.get("rng_key"), seed, start_update - 1)
        restore_generator(player_gen, state.get("player_rng_key"), seed, start_update - 1, 1)

    reset_on_done = bool(algo["reset_recurrent_state_on_done"])
    initial_clip_coef, initial_ent_coef = float(algo["clip_coef"]), float(algo["ent_coef"])
    clip_coef, ent_coef = initial_clip_coef, initial_ent_coef
    coefs = torch.tensor([clip_coef, ent_coef], device=dev)
    metric_cfg = cfg["metric"]
    log_level, log_every = int(metric_cfg["log_level"]), int(metric_cfg["log_every"])
    aggregator = build_aggregator(cfg, AGGREGATOR_KEYS)
    count_flops = get_telemetry() is not None
    gamma = float(algo["gamma"])
    batch_size = int(algo["per_rank_batch_size"])

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        return {
            "agent": agent_to_flax(agent.state_dict()),
            "opt_state": optimizer_to_optax(opt, param_names, agent_to_flax),
            "update": completed_update,
            "batch_size": batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": train_gen.get_state().numpy(),
            "player_rng_key": player_gen.get_state().numpy(),
        }

    def ckpt_path_fn(step: int) -> str:
        return os.path.join(log_dir, "checkpoint", f"ckpt_{step}_0.ckpt")

    @torch.no_grad()
    def rollback(at_update: int) -> None:
        restored = resil.rollback(update=at_update)
        sd = agent_from_flax(restored["agent"])
        for name, p in agent.named_parameters():
            p.copy_(sd[name])
        optimizer_from_optax(restored["opt_state"], opt, param_names, agent_from_flax)
        if "rng_key" in restored:
            restore_generator(train_gen, restored["rng_key"], seed, int(restored["update"]))
        resil.resalt_key(train_gen)
        player.sync_params()

    def on_episode(env: int, ret: float, length: int, t: int) -> None:
        if log_level > 0:
            aggregator.update("Rewards/rew_avg", ret)
            aggregator.update("Game/ep_len_avg", float(length))
            print(f"Rank-0: policy_step={policy_step + (t + 1) * num_envs}, reward_env_{env}={ret}")

    # the host path: one captured update for each padded sequence count
    update_fns: Dict[int, CapturedStep] = {}
    fused_fn: Optional[CapturedStep] = None
    store = RolloutStore(rollout_steps, device=dev)
    local_train = make_local_train(agent, opt, cfg, obs_keys, train_gen, sequence_dones=fused_spec is not None)
    env_carry: Dict[str, torch.Tensor] = {}
    next_obs: Dict[str, np.ndarray] = {}
    hidden = agent.lstm_hidden_size
    # the host loop's recurrent carry lives with the player
    hx = torch.zeros(num_envs, hidden, device=player.device)
    cx = torch.zeros(num_envs, hidden, device=player.device)
    prev_actions = torch.zeros(num_envs, n_actions, device=player.device)
    if fused_spec is not None:
        thetas = None
        if isinstance(fused_spec, ScenarioFamily):
            theta_gen = torch.Generator(device=dev).manual_seed(seed if variant_seed is None else variant_seed)
            thetas = sample_scenario_matrix(theta_gen, num_envs, fused_spec.variant_names, ranges)
        env_carry = init_recurrent_env_carry(fused_spec, num_envs, env_gen, hidden, n_actions, thetas)
        superstep = make_recurrent_onpolicy_superstep_fn(
            fused_spec,
            policy_fn=lambda obs, pa, h, c, g: recurrent_rollout_step(agent, obs, pa, h, c, g),
            value_fn=lambda obs, pa, h, c: agent(obs, pa, h, c)[1],
            local_train=local_train,
            obs_key=mlp_keys[0],
            rollout_steps=rollout_steps,
            seq_len=seq_len,
            gamma=gamma,
            gae_lambda=float(algo["gae_lambda"]),
            reset_on_done=reset_on_done,
            policy_generator=player_gen,
            env_generator=env_gen,
        )

        def fused_update(d: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
            metrics, stats = superstep({k: v for k, v in d.items() if k != "coefs"}, d["coefs"])
            return metrics, stats["done"], stats["ret"], stats["len"]

        fused_fn = CapturedStep(
            fused_update,
            {**env_carry, "coefs": coefs},
            opt_state_tensors(agent, opt) + list(env_carry.values()),
            (player_gen, env_gen, train_gen),
        )
        fused_fn.count_flops = count_flops
    else:
        obs, _ = envs.reset(seed=seed)
        next_obs = prepare_obs(obs, cnn_keys=cnn_keys, num_envs=num_envs)

    def host_update_fn(buf_arrays: Dict[str, torch.Tensor], n_pad: int) -> CapturedStep:
        # the rollout buffers are shared by every count's graph; the rest is its own
        fn = update_fns.get(n_pad)
        if fn is None:
            inputs = dict(buf_arrays)
            for k in obs_keys:
                inputs[f"next/{k}"] = torch.zeros_like(inputs[k][0])
            inputs["next/prev_actions"] = torch.zeros_like(prev_actions, device=dev)
            inputs["next/hx"], inputs["next/cx"] = torch.zeros_like(hx, device=dev), torch.zeros_like(cx, device=dev)
            inputs["seq/index"] = torch.zeros(seq_len, n_pad, dtype=torch.int64, device=dev)
            inputs["seq/mask"] = torch.zeros(seq_len, n_pad, 1, device=dev)
            inputs["seq/start"] = torch.zeros(n_pad, dtype=torch.int64, device=dev)
            inputs["seq/valid"] = torch.zeros(n_pad, 1, device=dev)
            inputs["coefs"] = coefs
            fn = CapturedStep(make_update_fn(agent, local_train, cfg, obs_keys), inputs, opt_state_tensors(agent, opt), train_gen)
            # the first graph's warm-up is counted for the run's FLOPs
            fn.count_flops = count_flops and not update_fns
            update_fns[n_pad] = fn
        return fn

    train_windows = last_train = 0
    metrics: Optional[torch.Tensor] = None
    update_fn: Optional[CapturedStep] = fused_fn
    preempted = False
    update = start_update
    windows: List[Tuple[Any, Any]] = []
    wall: List[float] = []
    env_seconds = 0.0
    resil.arm_crash_guard(path_fn=lambda: ckpt_path_fn(policy_step), state_fn=lambda: ckpt_state_fn(update - 1))
    t_start = time.perf_counter()
    try:
        for update in range(start_update, num_updates + 1):
            telemetry_advance(policy_step)
            if resil.preempt_requested():
                last_checkpoint = policy_step
                resil.emergency_checkpoint(ckpt_path_fn(policy_step), ckpt_state_fn(update - 1))
                preempted = True
                break
            t_update = time.perf_counter()
            coefs.copy_(torch.tensor([clip_coef, ent_coef]), non_blocking=True)
            if fused_fn is not None:
                with timer("Time/env_interaction_time"):
                    start = _clock(dev)
                    metrics, ep_done, ep_ret, ep_len = fused_fn()
                    windows.append((start, _clock(dev)))
                    metrics_np = metrics.cpu().numpy()
                telemetry_train_window(1, steps_per_update)
                if log_level > 0:
                    done = ep_done.cpu().numpy()
                    if done.any():
                        rets, lens = ep_ret.cpu().numpy(), ep_len.cpu().numpy()
                        for t, i in zip(*np.nonzero(done)):
                            on_episode(int(i), float(rets[t, i]), int(lens[t, i]), int(t))
                policy_step += policy_steps_per_update
            else:
                buf = store.begin(update)
                t_env = time.perf_counter()
                with timer("Time/env_interaction_time"):
                    next_obs, (prev_actions, hx, cx), host_dones = collect_rollout(
                        player, envs, buf, next_obs, (prev_actions, hx, cx), player_gen, rollout_steps, gamma, cnn_keys, reset_on_done, on_episode
                    )
                policy_step += policy_steps_per_update
                env_seconds += time.perf_counter() - t_env
                layout = sequence_layout(host_dones, seq_len, num_batches)
                update_fn = host_update_fn(buf.arrays(), layout.index.shape[1])
                inputs = update_fn.inputs
                for k in obs_keys:
                    inputs[f"next/{k}"].copy_(torch.from_numpy(next_obs[k]), non_blocking=True)
                inputs["next/prev_actions"].copy_(prev_actions)
                inputs["next/hx"].copy_(hx)
                inputs["next/cx"].copy_(cx)
                for k, v in zip(("seq/index", "seq/mask", "seq/start", "seq/valid"), layout):
                    inputs[k].copy_(torch.from_numpy(v), non_blocking=True)
                with timer("Time/train_time"):
                    start = _clock(dev)
                    metrics = update_fn()
                    windows.append((start, _clock(dev)))
                    metrics_np = metrics.cpu().numpy()
                telemetry_train_window(rollout_steps + 1, steps_per_update)
            wall.append(time.perf_counter() - t_update)
            if update == start_update:
                first_fn = update_fn
                telemetry_register_flops(lambda: first_fn.flops, scale=1.0 / steps_per_update)
                telemetry_mark_warm()
            train_windows += 1
            if resil.finite_checks and not resil.check_finite(metrics_np, update):
                rollback(update)
                if fused_fn is not None:
                    fresh = init_recurrent_env_carry(fused_spec, num_envs, env_gen, hidden, n_actions, env_carry.get("theta"))
                    for k, v in fresh.items():
                        fused_fn.inputs[k].copy_(v)
                continue
            player.sync_params()
            if log_level > 0:
                for name, value in zip(METRIC_ORDER, metrics_np):
                    aggregator.update(name, float(value))
            if log_level > 0 and (policy_step - last_log >= log_every or update == num_updates):
                metrics_dict = aggregator.compute()
                logger.log_metrics(metrics_dict, policy_step)
                telemetry_run_metrics(metrics_dict)
                aggregator.reset()
                log_sps_and_heartbeat(
                    logger,
                    policy_step=policy_step,
                    env_steps=(policy_step - last_log) * int(cfg["env"]["action_repeat"]),
                    train_steps=(train_windows - last_train) * steps_per_update,
                    train_invocations=train_windows - last_train,
                )
                last_log = policy_step
                last_train = train_windows
            if algo["anneal_clip_coef"]:
                clip_coef = polynomial_decay(update, initial=initial_clip_coef, final=0.0, max_decay_steps=num_updates, power=1.0)
            if algo["anneal_ent_coef"]:
                ent_coef = polynomial_decay(update, initial=initial_ent_coef, final=0.0, max_decay_steps=num_updates, power=1.0)
            if (int(ckpt_cfg["every"]) > 0 and policy_step - last_checkpoint >= int(ckpt_cfg["every"])) or (
                update == num_updates and ckpt_cfg["save_last"]
            ):
                last_checkpoint = policy_step
                callback.on_checkpoint_coupled(ckpt_path_fn(policy_step), ckpt_state_fn(update))
    except BaseException as err:
        if isinstance(err, Exception):
            resil.crash_checkpoint(err)
        resil.close()
        logger.finalize()
        envs.close()
        raise
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t_start
    envs.close()
    test_reward, test_steps = None, 0
    player.sync_params()
    if algo.get("run_test", True) and not preempted:
        if obs_widened:
            warnings.warn("skipping run_test: env.variants widened the observation past the host env's")
        else:
            test_reward, test_steps = test(player, cfg, log_dir, logger=logger)
    logger.finalize()
    resil.close()
    if preempted:
        resil.exit_preempted()
    graphs = [fused_fn] if fused_fn is not None else list(update_fns.values())
    return {
        "log_dir": log_dir,
        "start_update": start_update,
        "updates": train_windows,
        "env_steps": policy_step,
        "gradient_steps": train_windows * steps_per_update,
        "seconds": seconds,
        "env_seconds": env_seconds,
        "update_seconds": [_elapsed(a, b) for a, b in windows],
        "update_wall_seconds": wall,
        "metrics": {} if metrics is None else dict(zip(METRIC_ORDER, metrics.cpu().tolist())),
        "rollbacks": resil.rollbacks,
        "last_checkpoint": last_checkpoint,
        "fused_rollout": fused_spec is not None,
        "replays": sum(g.replays for g in graphs),
        # the host path's update graphs, one for each padded sequence count
        "captures": len(graphs),
        "sequence_counts": sorted(update_fns),
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }
