"""Dreamer-V2 training (port of ``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``:
``make_train_fn`` :78-310 and ``main`` :312-703), on one device.

One gradient step (:func:`make_train_step`): the world model over a
``[T, B]`` batch (``rssm_scan`` from zero states, the decoders' and the
reward's ``Normal(mean, 1)`` likelihoods, the optional continue model and
the KL-balanced state loss) and its Adam step; an imagination of
``horizon`` steps from every posterior with the updated world model; the
lambda-returns with a bootstrap (``compute_lambda_values_bootstrap``)
against the target critic; the actor's objective ``objective_mix *
reinforce + (1 - objective_mix) * dynamics`` with its entropy bonus, and
the critic fitted to the lambda-returns. Each model's gradients are clipped
by its ``clip_gradients``. The dynamics term's gradient runs back through
imagination; at ``objective_mix`` 1 (the default) that gradient is zero and
imagination runs without it. The target critic is a hard copy of the
critic every ``per_rank_target_network_update_freq`` steps, from step 0.
On the card the step is one ``CapturedStep`` replay, as Dreamer-V3's.

``main`` runs the JAX loop: each row stores the observation the env
returned with the action that led to it (the first row of an episode a
zero action and ``is_first``), uniform random actions up to
``learning_starts`` on a fresh run, then the player's with the actor's
exploration noise; ``buffer.type`` ``sequential`` (the ring or the host
buffer that ``buffer.device`` picks) or ``episode``
(``data/buffers.py::EpisodeBuffer``); ``Ratio`` with
``per_rank_pretrain_steps``; Dreamer-V3's train windows
(``ReplayTrainer``) and log windows; checkpoints in the JAX layout and
keys, resumed from either package's; the final test episode.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    ActorDV2,
    CriticDV2,
    WorldModelDV2,
    actor_logprob_entropy,
    build_agent,
    rssm_scan,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v2.convert import checkpoint_state, load_checkpoint_state
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import AGGREGATOR_KEYS, prepare_obs, test
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    LogWindows,
    ReplayTrainer,
    _grads,
    build_optimizers,
    loop_state,
    place_dreamer_player,
    random_actions,
    replay_kind,
    resolve_fabric,
)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import env_action
from sheeprl_tpu_torch.data.buffers import EpisodeBuffer
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.obs.telemetry import telemetry_advance
from sheeprl_tpu_torch.ops.distributions import Bernoulli, Independent, Normal, OneHotCategorical
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.ops.math import compute_lambda_values_bootstrap
from sheeprl_tpu_torch.ops.optim import Adam
from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events, resolve_auto_resume
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, select_buffer
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import save_configs

METRIC_ORDER = (
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Loss/policy_loss",
    "Loss/value_loss",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
)
TrainStep = Callable[..., torch.Tensor]


def world_model_step(wm: WorldModelDV2, world_opt: Adam, data: Dict[str, torch.Tensor], cfg: Dict[str, Any], generator: Optional[torch.Generator], detach_heads: bool = False):
    """The world model's loss over the batch and its Adam step (JAX
    :151-205); ``detach_heads`` feeds the reward and continue heads detached
    latents, as P2E does. Returns ``(hs, zs, metrics [8], grad norm,
    grads)``, ``metrics`` the first eight of ``METRIC_ORDER``."""
    algo = cfg["algo"]
    wmc = algo["world_model"]
    cnn_keys, mlp_keys = tuple(algo["cnn_keys"]["encoder"]), tuple(algo["mlp_keys"]["encoder"])
    cnn_dec, mlp_dec = tuple(algo["cnn_keys"]["decoder"]), tuple(algo["mlp_keys"]["decoder"])
    kl_args = (float(wmc["kl_balancing_alpha"]), float(wmc["kl_free_nats"]), bool(wmc["kl_free_avg"]), float(wmc["kl_regularizer"]))
    is_first = data["is_first"].clone()
    is_first[0] = 1.0
    obs_targets = {k: data[k].float() / 255.0 - 0.5 for k in cnn_dec}
    obs_targets.update({k: data[k].float() for k in mlp_dec})
    embedded = wm.encode({k: data[k] for k in cnn_keys + mlp_keys})
    hs, zs, post_logits, prior_logits = rssm_scan(wm, embedded, data["actions"], is_first, generator)
    latents = torch.cat([zs, hs], -1)
    recon = wm.decode(latents)
    po = {k: Independent(Normal(recon[k], torch.ones_like(recon[k])), 3 if k in cnn_dec else 1) for k in cnn_dec + mlp_dec}
    head_in = latents.detach() if detach_heads else latents
    reward_mean = wm.reward_mean(head_in)
    pr = Independent(Normal(reward_mean, torch.ones_like(reward_mean)), 1)
    pc = continue_targets = None
    if bool(wmc["use_continues"]):
        pc = Independent(Bernoulli(wm.continue_logits(head_in)), 1)
        continue_targets = (1 - data["terminated"]) * float(algo["gamma"])
    rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
        po, obs_targets, pr, data["rewards"], prior_logits, post_logits, *kl_args, pc, continue_targets, float(wmc["discount_scale_factor"])
    )
    grads = _grads(rec_loss, list(wm.parameters()))
    gnorm = world_opt.step(grads)
    with torch.no_grad():
        post_ent = Independent(OneHotCategorical(post_logits.detach()), 1).entropy().mean()
        prior_ent = Independent(OneHotCategorical(prior_logits.detach()), 1).entropy().mean()
    return hs, zs, [rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, post_ent, prior_ent], gnorm, grads


def imagine(wm: WorldModelDV2, actor: ActorDV2, start_z: torch.Tensor, start_h: torch.Tensor, horizon: int, generator: Optional[torch.Generator]):
    """Imagination from ``(start_z, start_h)`` (JAX :213-232): ``horizon
    + 1`` latents ``[H+1, N, L]``, the start first, and the actions that
    led to each (a zero action before the start) ``[H+1, N, A]``."""
    z, h = start_z, start_h
    lat = torch.cat([z, h], -1)
    lats, acts = [lat], [torch.zeros(lat.shape[0], sum(actor.actions_dim), device=lat.device)]
    for _ in range(horizon):
        action = sample_actor_actions(actor, lat.detach(), generator)
        z, h = wm.imagination(z, h, action, generator)
        lat = torch.cat([z, h], -1)
        lats.append(lat)
        acts.append(action)
    return torch.stack(lats), torch.stack(acts)


def make_train_step(
    wm: WorldModelDV2,
    actor: ActorDV2,
    critic: CriticDV2,
    target_critic: CriticDV2,
    world_opt: Adam,
    actor_opt: Adam,
    critic_opt: Adam,
    cfg: Dict[str, Any],
) -> TrainStep:
    """``train_step(data, generator=None, grads_out=None) -> metrics [13]``
    (``METRIC_ORDER``), one gradient step over the ``[T, B, ...]`` batch
    ``data`` (obs keys, ``actions``, ``rewards``, ``terminated``,
    ``is_first``), the three models and their optimizers updated in place;
    ``grads_out``, a dict, receives each model's gradients before clipping
    (``world_model``, ``actor``, ``critic``)."""
    algo = cfg["algo"]
    horizon, gamma, lmbda = int(algo["horizon"]), float(algo["gamma"]), float(algo["lmbda"])
    ent_coef, mix = float(algo["actor"]["ent_coef"]), float(algo["actor"]["objective_mix"])
    use_continues = bool(algo["world_model"]["use_continues"])

    def train_step(
        data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, grads_out: Optional[Dict[str, List[torch.Tensor]]] = None
    ) -> torch.Tensor:
        T, B = data["rewards"].shape[:2]
        hs, zs, wm_metrics, wm_gnorm, wm_grads = world_model_step(wm, world_opt, data, cfg, generator)

        # behaviour: imagination from every posterior with the updated world
        # model (JAX :213-262); the dynamics term needs its gradient
        with torch.set_grad_enabled(mix != 1.0):
            trajectories, imagined_actions = imagine(wm, actor, zs.detach().reshape(T * B, -1), hs.detach().reshape(T * B, -1), horizon, generator)
            target_values = target_critic(trajectories)
            rewards = wm.reward_mean(trajectories)
            if use_continues:
                continues = torch.sigmoid(wm.continue_logits(trajectories))
                true_continue = (1 - data["terminated"]).reshape(1, T * B, 1) * gamma
                continues = torch.cat([true_continue, continues[1:]], 0)
            else:
                continues = torch.ones_like(rewards) * gamma
            lambda_values = compute_lambda_values_bootstrap(
                rewards[:-1], target_values[:-1], continues[:-1], bootstrap=target_values[-1:], lmbda=lmbda
            )
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], 0), 0).detach()
        advantage = (lambda_values[1:] - target_values[:-2]).detach()
        logp, entropy = actor_logprob_entropy(actor, trajectories[:-2].detach(), imagined_actions[1:-1].detach())
        objective = mix * (logp[..., None] * advantage)
        if mix != 1.0:
            objective = objective + (1 - mix) * lambda_values[1:]
        policy_loss = -torch.mean(discount[:-2] * (objective + ent_coef * entropy[..., None]))
        actor_grads = _grads(policy_loss, list(actor.parameters()))
        actor_gnorm = actor_opt.step(actor_grads)

        # the critic against the lambda-returns (JAX :274-283)
        qv = critic(trajectories[:-1].detach())
        value_loss = -torch.mean(discount[:-1][..., 0] * Independent(Normal(qv, torch.ones_like(qv)), 1).log_prob(lambda_values.detach()))
        critic_grads = _grads(value_loss, list(critic.parameters()))
        critic_gnorm = critic_opt.step(critic_grads)

        if grads_out is not None:
            grads_out.update(world_model=wm_grads, actor=actor_grads, critic=critic_grads)
        return torch.stack([*wm_metrics, policy_loss, value_loss, wm_gnorm, actor_gnorm, critic_gnorm]).detach()

    return train_step


def make_train_fn(
    train_step: TrainStep,
    wm: WorldModelDV2,
    actor: ActorDV2,
    critic: CriticDV2,
    opts: Sequence[Adam],
    inputs: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
) -> CapturedStep:
    """``train_step`` over the static batch ``inputs`` as a
    ``CapturedStep``: one CUDA-graph replay on the card, eager on the
    CPU."""
    state = [*wm.parameters(), *actor.parameters(), *critic.parameters()]
    for opt in opts:
        state += [*opt.mu, *opt.nu, opt.count]
    return CapturedStep(lambda data: train_step(data, generator), inputs, state, generator)


@torch.no_grad()
def hard_copy_(critic: CriticDV2, target_critic: CriticDV2) -> None:
    """The target critic := the critic, in place (JAX :429-431)."""
    torch._foreach_copy_(list(target_critic.parameters()), list(critic.parameters()))


class EnvLoopDV2:
    """The env side of the JAX loop (:560-668): the first row of each env's
    episode (zero action and reward, ``is_first``) goes in at reset; each
    ``step`` takes an action per env (uniform random ones, or the player's
    with exploration noise), steps the envs and stores the row of the
    observation it returned (the true final one of an ended episode) with
    that action; an ended episode's env then stores its reset observation as
    the next episode's first row and its player state restarts. Dreamer-V1
    and the P2E loops over Dreamer-V1/V2 run it too, with
    ``close_first_in_dry_run=False``."""

    def __init__(
        self,
        envs: Any,
        rb: Any,
        player: Any,
        cfg: Dict[str, Any],
        aggregator: Any,
        player_gen: torch.Generator,
        action_rng: np.random.Generator,
        close_first_in_dry_run: bool = True,
    ) -> None:
        self.envs, self.rb, self.player, self.aggregator = envs, rb, player, aggregator
        self.player_gen, self.action_rng = player_gen, action_rng
        self.action_space = envs.single_action_space
        self.actions_dim, self.is_continuous = action_dims(self.action_space)
        self.n_actions = int(sum(self.actions_dim))
        self.num_envs = int(cfg["env"]["num_envs"])
        self.cnn_keys = list(cfg["algo"]["cnn_keys"]["encoder"])
        self.obs_keys = self.cnn_keys + list(cfg["algo"]["mlp_keys"]["encoder"])
        self.clip_rewards = bool(cfg["env"].get("clip_rewards", False))
        self.log_level = int(cfg["metric"]["log_level"])
        self.dry_run = bool(cfg.get("dry_run", False))
        self.close_first_in_dry_run = close_first_in_dry_run
        self.episode = isinstance(rb, EpisodeBuffer)
        self.validate = bool(cfg["buffer"].get("validate_args", False))
        self.step_data: Dict[str, np.ndarray] = {}
        self.obs: Dict[str, np.ndarray] = {}

    def _first_rows(self, obs: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
        prepared = prepare_obs(obs, cnn_keys=self.cnn_keys, num_envs=n)
        rows = {k: prepared[k][np.newaxis] for k in self.obs_keys}
        zeros = np.zeros((1, n, 1), np.float32)
        rows.update(terminated=zeros.copy(), truncated=zeros.copy(), rewards=zeros.copy(), is_first=np.ones_like(zeros))
        rows["actions"] = np.zeros((1, n, self.n_actions), np.float32)
        return rows

    def reset(self, seed: int) -> None:
        """Reset the envs, store each env's first row and reset the player."""
        obs, _ = self.envs.reset(seed=seed)
        self.obs = obs
        self.step_data = self._first_rows(obs, self.num_envs)
        if self.dry_run and self.close_first_in_dry_run:
            # a length-1 episode closes at once, so the episode buffer can
            # sample (JAX :570-573; not in Dreamer-V1's loop or P2E's)
            self.step_data["truncated"] += 1
            self.step_data["terminated"] += 1
        self.rb.add(self.step_data, validate_args=self.validate)
        self.player.init_states()

    def step(self, random: bool, policy_step: int) -> None:
        n, step_data = self.num_envs, self.step_data
        with timer("Time/env_interaction_time"):
            if random:
                actions, real_actions = random_actions(self.action_rng, self.action_space, self.actions_dim, n)
            else:
                prepared = prepare_obs(self.obs, cnn_keys=self.cnn_keys, num_envs=n)
                actions = self.player.get_actions(prepared, self.player_gen, expl_step=policy_step, with_exploration=True)
                real_actions = [env_action(a, self.actions_dim, self.is_continuous) for a in actions]
            # the next stored row starts an episode where this one ended one
            step_data["is_first"] = np.logical_or(step_data["terminated"], step_data["truncated"]).astype(np.float32)
            next_obs, rewards, terminated, truncated, infos = self.envs.step(np.asarray(real_actions).reshape(n, *self.action_space.shape))
            dones = np.logical_or(terminated, truncated)
            if self.dry_run and self.episode:
                dones = np.ones_like(dones)
        if "restart_on_exception" in infos:
            for i, roe in enumerate(np.asarray(infos["restart_on_exception"]).reshape(-1)):
                if roe and not dones[i]:
                    step_data["is_first"][0, i] = 1.0
        if self.log_level > 0 and "final_info" in infos:
            ep = infos["final_info"].get("episode")
            if ep is not None:
                for i in np.nonzero(ep.get("_r", []))[0]:
                    self.aggregator.update("Rewards/rew_avg", float(ep["r"][i]))
                    self.aggregator.update("Game/ep_len_avg", float(ep["l"][i]))
        # the true final observation of an ended episode (JAX :641-648)
        real_next = {k: np.asarray(next_obs[k]).copy() for k in self.obs_keys}
        if "final_obs" in infos:
            for idx, final in enumerate(infos["final_obs"]):
                if final is not None:
                    for k in self.obs_keys:
                        real_next[k][idx] = final[k]
        prepared = prepare_obs(real_next, cnn_keys=self.cnn_keys, num_envs=n)
        for k in self.obs_keys:
            step_data[k] = prepared[k][np.newaxis]
        self.obs = next_obs
        step_data["terminated"] = np.asarray(terminated, np.float32).reshape(1, n, 1)
        step_data["truncated"] = np.asarray(truncated, np.float32).reshape(1, n, 1)
        step_data["actions"] = np.asarray(actions, np.float32).reshape(1, n, -1)
        rewards = np.asarray(rewards, np.float32).reshape(1, n, 1)
        step_data["rewards"] = np.tanh(rewards) if self.clip_rewards else rewards
        self.rb.add(step_data, validate_args=self.validate)
        dones_idxes = np.asarray(dones).reshape(-1).nonzero()[0].tolist()
        if dones_idxes:
            # the reset observation as the next episode's first row
            reset = self._first_rows({k: np.asarray(next_obs[k])[dones_idxes] for k in self.obs_keys}, len(dones_idxes))
            self.rb.add(reset, dones_idxes, validate_args=self.validate)
            step_data["terminated"][0, dones_idxes] = 0.0
            step_data["truncated"][0, dones_idxes] = 0.0
            self.player.init_states(dones_idxes)


def make_replay(cfg: Dict[str, Any], log_dir: str, obs_keys: Sequence[str]) -> Optional[EpisodeBuffer]:
    """``buffer.type``: None for ``sequential`` (``loop_state`` builds the
    sequence replay), an ``EpisodeBuffer`` for ``episode``; anything else
    raises with the JAX message (:415)."""
    buffer_type = str(cfg["buffer"].get("type", "sequential")).lower()
    if buffer_type == "sequential":
        return None
    if buffer_type != "episode":
        raise ValueError(f"Unrecognized buffer type: must be one of `sequential` or `episode`, received: {buffer_type}")
    dry_run = bool(cfg.get("dry_run", False))
    return EpisodeBuffer(
        int(cfg["buffer"]["size"]) // int(cfg["env"]["num_envs"]) if not dry_run else 2,
        minimum_episode_length=1 if dry_run else int(cfg["algo"]["per_rank_sequence_length"]),
        n_envs=int(cfg["env"]["num_envs"]),
        obs_keys=obs_keys,
        prioritize_ends=bool(cfg["buffer"].get("prioritize_ends", False)),
        memmap=bool(cfg["buffer"]["memmap"]),
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
        seed=int(cfg["seed"]),
    )


def check_keys(cfg: Dict[str, Any]) -> None:
    """The decoder keys are among the encoder's (JAX :343-351)."""
    algo = cfg["algo"]
    cnn, mlp = set(algo["cnn_keys"]["encoder"]), set(algo["mlp_keys"]["encoder"])
    cnn_dec, mlp_dec = set(algo["cnn_keys"]["decoder"]), set(algo["mlp_keys"]["decoder"])
    if not (cnn & cnn_dec) and not (mlp & mlp_dec):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    if cnn_dec - cnn:
        raise RuntimeError("The CNN keys of the decoder must be contained in the encoder ones.")
    if mlp_dec - mlp:
        raise RuntimeError("The MLP keys of the decoder must be contained in the encoder ones.")


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train Dreamer-V2, called as the CLI calls it, ``main(fabric, cfg)``,
    or as ``main(cfg, device=...)`` (the CUDA card unless
    ``device="cpu"``), for ``algo.total_steps`` env steps (one update with
    ``dry_run``), as the JAX ``main`` runs it on one device. Returns the
    run's counts, seconds and metrics."""
    fabric, cfg, callback = resolve_fabric(fabric, cfg, device)
    dev = fabric.device
    algo, ckpt_cfg, buffer_cfg = cfg["algo"], cfg["checkpoint"], cfg["buffer"]
    seed = int(cfg["seed"])
    resume_from = ckpt_cfg["resume_from"]
    if resume_from == "auto":
        resume_from = resolve_auto_resume(cfg)
        emit_pending_resilience_events()
    state = load_checkpoint(resume_from) if resume_from else None
    # these arguments cannot be changed (JAX :316-318): the decoder
    # reconstructs 64x64 exactly
    cfg["env"]["screen_size"] = 64
    cfg["env"]["frame_stack"] = 1
    check_keys(cfg)
    num_envs = int(cfg["env"]["num_envs"])
    log_dir = get_log_dir(cfg)
    logger = fabric.logger = get_logger(cfg, log_dir)
    logger.log_hyperparams(cfg)
    print(f"Log dir: {log_dir}")
    save_configs(cfg, log_dir)
    envs = build_vector_env(cfg, 0, log_dir, "train", restart_on_exception=True)
    obs_space = envs.single_observation_space
    actions_dim, is_continuous = action_dims(envs.single_action_space)
    obs_keys = list(algo["cnn_keys"]["encoder"]) + list(algo["mlp_keys"]["encoder"])

    wm, actor, critic, target_critic, player = build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    opts = build_optimizers(cfg, wm, actor, critic)
    if state is not None:
        load_checkpoint_state(state, wm, actor, critic, target_critic, opts)
    place_dreamer_player(player, cfg, dev)
    train_step = make_train_step(wm, actor, critic, target_critic, *opts, cfg)

    episode_rb = make_replay(cfg, log_dir, obs_keys)
    if episode_rb is not None and state is not None and buffer_cfg["checkpoint"]:
        episode_rb = select_buffer(state["rb"], 0, 1)
        if not isinstance(episode_rb, EpisodeBuffer):
            raise ValueError(f"buffer.type=episode cannot resume from a checkpoint's {type(episode_rb).__name__}")
    sequence_state = state if buffer_cfg["checkpoint"] and episode_rb is None else None
    ls = loop_state(cfg, dev, obs_space, actions_dim, log_dir, state, sequence_state, player.device, rb=episode_rb)
    rb, ratio = ls.rb, ls.ratio
    policy_step, last_log, last_checkpoint = ls.policy_step, ls.last_log, ls.last_checkpoint

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        return {
            **checkpoint_state(wm, actor, critic, target_critic, opts),
            "ratio": ratio.state_dict(),
            "update": completed_update,
            "batch_size": ls.batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": ls.train_gen.get_state().numpy(),
            "player_rng_key": ls.player_gen.get_state().numpy(),
        }

    aggregator = build_aggregator(cfg, AGGREGATOR_KEYS)
    env_loop = EnvLoopDV2(envs, rb, player, cfg, aggregator, ls.player_gen, np.random.default_rng(seed))
    env_loop.reset(seed)
    trainer = ReplayTrainer(
        cfg,
        rb,
        ls.batch_size,
        lambda inputs: make_train_fn(train_step, wm, actor, critic, opts, inputs, ls.train_gen),
        lambda tau: hard_copy_(critic, target_critic),
        dev,
    )
    logs = LogWindows(cfg, logger, aggregator, METRIC_ORDER, last_log)
    t_start = time.perf_counter()
    try:
        for update in range(ls.start_step, ls.num_updates + 1):
            telemetry_advance(policy_step)
            policy_step += num_envs
            env_loop.step(random=update <= ls.learning_starts and state is None, policy_step=policy_step)
            n_steps = ratio(policy_step) if update >= ls.learning_starts else 0
            if n_steps > 0:
                trainer.window(n_steps)
                # a placed player's copy lands at a later action (JAX :631-632)
                player.stream_params()
            logs.maybe_log(policy_step, update == ls.num_updates, trainer)
            last_log = logs.last_log
            if (int(ckpt_cfg["every"]) > 0 and policy_step - last_checkpoint >= int(ckpt_cfg["every"])) or (
                update == ls.num_updates and ckpt_cfg["save_last"]
            ):
                last_checkpoint = policy_step
                path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
                callback.on_checkpoint_coupled(path, ckpt_state_fn(update), rb if buffer_cfg["checkpoint"] else None)
    except BaseException:
        logger.finalize()
        envs.close()
        raise
    trainer.finish()
    seconds = time.perf_counter() - t_start
    envs.close()
    # the test plays the last window's params (JAX :699)
    player.flush_params()
    test_reward, test_steps = None, 0
    if algo.get("run_test", False):
        test_reward, test_steps = test(player, cfg, log_dir, greedy=False, logger=logger)
    logger.finalize()
    return {
        "log_dir": log_dir,
        "start_update": ls.start_step,
        "env_steps": policy_step,
        "seconds": seconds,
        "log": logs.logged,
        "last_checkpoint": last_checkpoint,
        **trainer.report(METRIC_ORDER),
        "replay_buffer": "episode" if isinstance(rb, EpisodeBuffer) else replay_kind(rb),
        "episodes": len(rb.buffer) if isinstance(rb, EpisodeBuffer) else None,
        "player_device": str(player.device),
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }
