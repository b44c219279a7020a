"""Dreamer-V3 training (port of ``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``:
``make_train_step`` :103-328, the target-critic EMA :573-575 and the loop of
``main`` :817-1060).

One gradient step is ``make_train_step``'s closure over the three models,
their optimizers and the target critic, on one process: the world-model
step through ``rssm_scan``, imagination over ``horizon + 1`` steps from
every posterior with the updated world model, the actor loss with the
Moments return normaliser, and the critic loss against the target critic.
With discrete actions no gradient reaches imagination (the advantage,
trajectories, actions and discount are all out of the actor's gradient), so
it runs under ``torch.no_grad``; with continuous actions the objective is
the advantage itself and the gradient flows back through every imagined
step, the fused RSSM step's backward included.

``main`` is the loop cut to its core: env steps through ``PlayerDV3``
(random actions before ``learning_starts``), sequence replay, ``Ratio``,
the train steps and the EMA. Checkpoint and resume, telemetry, fused
supersteps, the device ring, NaN rollback and multiple processes are not
ported (ROADMAP queue A).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    Critic,
    WorldModel,
    actor_logprob_entropy,
    build_agent,
    build_critic,
    rssm_scan,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import env_action, prepare_obs
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.envs.spaces import Box, action_dims
from sheeprl_tpu_torch.ops.distributions import (
    Bernoulli,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
)
from sheeprl_tpu_torch.ops.math import MomentsState, compute_lambda_values, init_moments, update_moments
from sheeprl_tpu_torch.ops.optim import Adam, adam
from sheeprl_tpu_torch.utils.utils import Ratio

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

TrainStep = Callable[..., Tuple[MomentsState, torch.Tensor]]


def _grads(loss: torch.Tensor, params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not reach."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def make_train_step(
    wm: WorldModel,
    actor: Actor,
    critic: Critic,
    target_critic: Critic,
    world_opt: Adam,
    actor_opt: Adam,
    critic_opt: Adam,
    cfg: Dict[str, Any],
    is_continuous: bool,
) -> TrainStep:
    """One gradient step over a time-major ``[T, B]`` batch.

    Returns ``train_step(moments, data, generator=None, grads_out=None) ->
    (moments, metrics)``: it updates the three models in place, returns the
    new ``MomentsState`` and the 13 metrics of ``METRIC_ORDER`` as one
    device tensor (no host sync). ``data`` holds the obs keys, ``actions``,
    ``rewards``, ``terminated`` and ``is_first`` as ``[T, B, ...]`` tensors
    on the models' device; ``grads_out``, a dict, receives each model's
    gradients before clipping (``world_model``, ``actor``, ``critic``).
    """
    algo = cfg["algo"]
    wmc = algo["world_model"]
    cnn_keys = tuple(algo["cnn_keys"]["encoder"])
    mlp_keys = tuple(algo["mlp_keys"]["encoder"])
    cnn_dec_keys = tuple(algo["cnn_keys"]["decoder"])
    mlp_dec_keys = tuple(algo["mlp_keys"]["decoder"])
    horizon = int(algo["horizon"])
    gamma = float(algo["gamma"])
    lmbda = float(algo["lmbda"])
    ent_coef = float(algo["actor"]["ent_coef"])
    kl_args = (float(wmc["kl_dynamic"]), float(wmc["kl_representation"]))
    kl_args += (float(wmc["kl_free_nats"]), float(wmc["kl_regularizer"]))
    continue_scale = float(wmc["continue_scale_factor"])
    mcfg = algo["actor"]["moments"]
    moments_args = dict(
        decay=float(mcfg["decay"]),
        max_=float(mcfg["max"]),
        percentile_low=float(mcfg["percentile"]["low"]),
        percentile_high=float(mcfg["percentile"]["high"]),
    )
    wm_params = list(wm.parameters())
    actor_params = list(actor.parameters())
    critic_params = list(critic.parameters())

    def imagine(start_z: torch.Tensor, start_h: torch.Tensor, generator: Optional[torch.Generator]):
        """``horizon + 1`` latents from the start states, each with the
        action sampled at it (the last step's successor is not kept)."""
        z, h = start_z, start_h
        lat = torch.cat([z, h], -1)
        lats, acts = [], []
        for _ in range(horizon + 1):
            action = sample_actor_actions(actor, lat.detach(), generator)
            lats.append(lat)
            acts.append(action)
            z, h = wm.imagination(z, h, action, generator)
            lat = torch.cat([z, h], -1)
        return torch.stack(lats), torch.stack(acts)

    def train_step(
        moments: MomentsState,
        data: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        grads_out: Optional[Dict[str, List[torch.Tensor]]] = None,
    ) -> Tuple[MomentsState, torch.Tensor]:
        T, B = data["rewards"].shape[:2]
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        # a_t in the RSSM input is the action that led to o_t
        batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)
        batch_obs = {k: data[k] for k in cnn_keys + mlp_keys}
        obs_targets = {k: data[k].float() / 255.0 - 0.5 for k in cnn_dec_keys}
        obs_targets.update({k: data[k].float() for k in mlp_dec_keys})

        # ---------------- world model ---------------- #
        embedded = wm.encode(batch_obs)
        hs, zs, post_logits, prior_logits = rssm_scan(wm, embedded, batch_actions, is_first, generator)
        latents = torch.cat([zs, hs], -1)
        recon = wm.decode(latents)
        po: Dict[str, Any] = {k: MSEDistribution(recon[k], dims=3) for k in cnn_dec_keys}
        po.update({k: SymlogDistribution(recon[k], dims=1) for k in mlp_dec_keys})
        pr = TwoHotEncodingDistribution(wm.reward_logits(latents), dims=1)
        pc = Independent(Bernoulli(wm.continue_logits(latents)), 1)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            po,
            obs_targets,
            pr,
            data["rewards"],
            prior_logits,
            post_logits,
            *kl_args,
            pc,
            1 - data["terminated"],
            continue_scale,
        )
        wm_grads = _grads(rec_loss, wm_params)
        wm_gnorm = world_opt.step(wm_grads)

        # ---------------- behaviour (imagination reads the updated model) ---------------- #
        start_z = zs.detach().reshape(T * B, -1)
        start_h = hs.detach().reshape(T * B, -1)
        true_continue = (1 - data["terminated"]).reshape(T * B, 1)
        with torch.set_grad_enabled(is_continuous):
            trajectories, imagined_actions = imagine(start_z, start_h, generator)
            values = TwoHotEncodingDistribution(critic(trajectories), dims=1).mean
            rewards = TwoHotEncodingDistribution(wm.reward_logits(trajectories), dims=1).mean
            continues = Independent(Bernoulli(wm.continue_logits(trajectories)), 1).mode
            continues = torch.cat([true_continue[None], continues[1:]], 0)
            lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * gamma, lmbda)
            discount = (torch.cumprod(continues * gamma, 0) / gamma).detach()
        moments, (offset, invscale) = update_moments(moments, lambda_values, **moments_args)
        baseline = values[:-1]
        advantage = (lambda_values - offset) / invscale - (baseline - offset) / invscale
        logp, entropy = actor_logprob_entropy(actor, trajectories.detach(), imagined_actions.detach())
        if is_continuous:
            objective = advantage
        else:
            objective = logp[..., None][:-1] * advantage.detach()
        policy_loss = -torch.mean(discount[:-1] * (objective + ent_coef * entropy[..., None][:-1]))
        actor_grads = _grads(policy_loss, actor_params)
        actor_gnorm = actor_opt.step(actor_grads)

        # ---------------- critic ---------------- #
        traj_in = trajectories[:-1].detach()
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target_critic(traj_in), dims=1).mean
        qv = TwoHotEncodingDistribution(critic(traj_in), dims=1)
        value_loss = -qv.log_prob(lambda_values.detach()) - qv.log_prob(target_values)
        value_loss = torch.mean(value_loss * discount[:-1].squeeze(-1))
        critic_grads = _grads(value_loss, critic_params)
        critic_gnorm = critic_opt.step(critic_grads)

        with torch.no_grad():
            post_ent = Independent(OneHotCategorical(post_logits), 1).entropy().mean()
            prior_ent = Independent(OneHotCategorical(prior_logits), 1).entropy().mean()
            metrics = torch.stack(
                [
                    rec_loss,
                    observation_loss,
                    reward_loss,
                    state_loss,
                    continue_loss,
                    kl,
                    post_ent,
                    prior_ent,
                    policy_loss,
                    value_loss,
                    wm_gnorm,
                    actor_gnorm,
                    critic_gnorm,
                ]
            ).detach()
        if grads_out is not None:
            grads_out.update(world_model=wm_grads, actor=actor_grads, critic=critic_grads)
        return moments, metrics

    return train_step


@torch.no_grad()
def ema_(critic: Critic, target_critic: Critic, tau: float) -> None:
    """``target = tau * critic + (1 - tau) * target``, in place."""
    target = list(target_critic.parameters())
    torch._foreach_mul_(target, 1 - tau)
    torch._foreach_add_(target, torch._foreach_mul(list(critic.parameters()), tau))


def build_optimizers(cfg: Dict[str, Any], wm: WorldModel, actor: Actor, critic: Critic) -> Tuple[Adam, Adam, Adam]:
    """The world-model, actor and critic optimizers of ``cfg``."""
    algo = cfg["algo"]
    return tuple(
        adam(list(m.parameters()), algo[k]["optimizer"], algo[k]["clip_gradients"])
        for m, k in ((wm, "world_model"), (actor, "actor"), (critic, "critic"))
    )


def random_actions(rng: np.random.Generator, action_space: Any, actions_dim: Sequence[int], n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(player_actions [n, A], env_actions)`` drawn uniformly: one-hots
    for a discrete space, a uniform draw in a bounded Box and a standard
    normal one in an unbounded Box."""
    if isinstance(action_space, Box):
        low, high = action_space.low, action_space.high
        bounded = np.isfinite(low) & np.isfinite(high)
        a = np.where(
            bounded,
            rng.uniform(np.where(bounded, low, 0), np.where(bounded, high, 1), (n, *action_space.shape)),
            rng.standard_normal((n, *action_space.shape)),
        ).astype(np.float32)
        return a, a
    idx = rng.integers(0, actions_dim[0], n)
    return np.eye(actions_dim[0], dtype=np.float32)[idx], idx


def to_batch(sample: Dict[str, np.ndarray], cnn_keys: Sequence[str], device: torch.device) -> Dict[str, torch.Tensor]:
    """One ``[T, B, ...]`` train batch from a replay sample's first draw:
    pixels stay uint8 across the bus, everything else goes fp32."""
    return {
        k: torch.as_tensor(v[0] if k in cnn_keys else v[0].astype(np.float32)).to(device) for k, v in sample.items()
    }


def main(cfg: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """Train Dreamer-V3 on ``device`` (the CUDA card unless
    ``device="cpu"``) for ``algo.total_steps`` env steps: the player acts
    (uniform random actions up to ``algo.learning_starts``), every step goes
    into sequence replay, and ``Ratio`` sets the gradient steps of each
    update. Returns the run's counts, seconds and the last metrics by name."""
    dev = resolve_device(device)
    algo = cfg["algo"]
    seed = int(cfg["seed"])
    screen = int(cfg["env"]["screen_size"])
    if 2 ** int(np.log2(screen)) != screen:
        raise ValueError(f"The screen size must be a power of 2, got: {screen}")
    num_envs = int(cfg["env"]["num_envs"])
    envs = [make_env(cfg, seed + i)() for i in range(num_envs)]
    action_space = envs[0].action_space
    obs_space = envs[0].observation_space
    actions_dim, is_continuous = action_dims(action_space)
    cnn_keys = list(algo["cnn_keys"]["encoder"])
    mlp_keys = list(algo["mlp_keys"]["encoder"])
    obs_keys = cnn_keys + mlp_keys
    clip_rewards = bool(cfg["env"].get("clip_rewards", False))

    wm, actor, player = build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    critic, target_critic = build_critic(cfg, wm.latent_state_size, device=dev)
    world_opt, actor_opt, critic_opt = build_optimizers(cfg, wm, actor, critic)
    train_step = make_train_step(wm, actor, critic, target_critic, world_opt, actor_opt, critic_opt, cfg, is_continuous)
    moments = init_moments(dev)

    dry_run = bool(cfg.get("dry_run", False))
    buffer_size = int(cfg["buffer"]["size"]) // num_envs if not dry_run else 2
    rb = EnvIndependentReplayBuffer(
        buffer_size, n_envs=num_envs, obs_keys=obs_keys, buffer_cls=SequentialReplayBuffer, seed=seed
    )
    num_updates = int(algo["total_steps"]) // num_envs if not dry_run else 1
    learning_starts = int(algo["learning_starts"]) // num_envs if not dry_run else 0
    batch_size = int(algo["per_rank_batch_size"])
    sequence_length = int(algo["per_rank_sequence_length"])
    critic_cfg = algo["critic"]
    ratio = Ratio(float(algo["replay_ratio"]), pretrain_steps=int(algo["per_rank_pretrain_steps"]))
    generator = torch.Generator(device=dev).manual_seed(seed)
    action_rng = np.random.default_rng(seed)

    step_data: Dict[str, np.ndarray] = {}
    obs = [env.reset(seed=seed + i)[0] for i, env in enumerate(envs)]
    stacked = {k: np.stack([o[k] for o in obs]) for k in obs_keys}
    prepared = prepare_obs(stacked, cnn_keys=cnn_keys, num_envs=num_envs)
    for k in obs_keys:
        step_data[k] = prepared[k][np.newaxis]
    zeros = np.zeros((1, num_envs, 1), np.float32)
    step_data.update(rewards=zeros.copy(), truncated=zeros.copy(), terminated=zeros.copy(), is_first=np.ones_like(zeros))
    player.init_states()

    policy_step = 0
    gradient_steps = 0
    train_seconds = 0.0
    metrics: Optional[torch.Tensor] = None
    t_start = time.perf_counter()
    for update in range(1, num_updates + 1):
        policy_step += num_envs
        if update <= learning_starts:
            actions, real_actions = random_actions(action_rng, action_space, actions_dim, num_envs)
        else:
            actions = player.get_actions(prepare_obs(stacked, cnn_keys=cnn_keys, num_envs=num_envs), generator)
            real_actions = [env_action(a, actions_dim, is_continuous) for a in actions]
        step_data["actions"] = np.asarray(actions, np.float32).reshape(1, num_envs, -1)
        rb.add(step_data)

        next_obs, final_obs, rewards, terminated, truncated = [], {}, [], [], []
        for i, env in enumerate(envs):
            o, r, term, trunc, _ = env.step(np.asarray(real_actions[i]).reshape(action_space.shape))
            if term or trunc:
                final_obs[i] = o
                o, _ = env.reset()
            next_obs.append(o)
            rewards.append(r)
            terminated.append(term)
            truncated.append(trunc)
        stacked = {k: np.stack([o[k] for o in next_obs]) for k in obs_keys}
        prepared = prepare_obs(stacked, cnn_keys=cnn_keys, num_envs=num_envs)
        for k in obs_keys:
            step_data[k] = prepared[k][np.newaxis]
        rewards = np.asarray(rewards, np.float32).reshape(1, num_envs, 1)
        step_data["rewards"] = np.tanh(rewards) if clip_rewards else rewards
        step_data["terminated"] = np.asarray(terminated, np.float32).reshape(1, num_envs, 1)
        step_data["truncated"] = np.asarray(truncated, np.float32).reshape(1, num_envs, 1)
        step_data["is_first"] = np.zeros_like(step_data["terminated"])

        dones = sorted(final_obs)
        if dones:
            # the terminal transition with the true final obs and a zero
            # action, then the per-env episode state restarts
            final = {k: np.stack([final_obs[i][k] for i in dones]) for k in obs_keys}
            prepared_final = prepare_obs(final, cnn_keys=cnn_keys, num_envs=len(dones))
            reset_data = {k: prepared_final[k][np.newaxis] for k in obs_keys}
            for k in ("terminated", "truncated", "rewards"):
                reset_data[k] = step_data[k][:, dones]
            reset_data["actions"] = np.zeros((1, len(dones), int(sum(actions_dim))), np.float32)
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            rb.add(reset_data, dones)
            for k in ("rewards", "terminated", "truncated"):
                step_data[k][:, dones] = 0.0
            step_data["is_first"][:, dones] = 1.0
            player.init_states(dones)

        if update >= learning_starts:
            n_steps = ratio(policy_step)
            if n_steps > 0:
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    sample = rb.sample(batch_size, sequence_length=sequence_length, n_samples=1)
                    batch = to_batch(sample, cnn_keys, dev)
                    if gradient_steps % int(critic_cfg["per_rank_target_network_update_freq"]) == 0:
                        ema_(critic, target_critic, 1.0 if gradient_steps == 0 else float(critic_cfg["tau"]))
                    moments, metrics = train_step(moments, batch, generator)
                    gradient_steps += 1
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                train_seconds += time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t_start
    for env in envs:
        env.close()
    last = {} if metrics is None else dict(zip(METRIC_ORDER, metrics.cpu().tolist()))
    return {
        "env_steps": policy_step,
        "gradient_steps": gradient_steps,
        "seconds": seconds,
        "train_seconds": train_seconds,
        "metrics": last,
        "moments": (float(moments.low), float(moments.high)),
    }
