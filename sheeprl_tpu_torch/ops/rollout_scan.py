"""Fused on-policy collection: the rollout, GAE and the update as one call
(port of ``sheeprl_tpu/ops/rollout_scan.py:67-503``: the PPO and A2C
superstep, and the recurrent one of recurrent PPO), which
``ops/graph.py::CapturedStep`` captures as one CUDA graph, so one update
with ``algo.fused_rollout`` is one graph replay on the card.

The call runs, for each of ``rollout_steps`` steps, in the JAX scan body's
order (:182-246): the observation of the carried env state, the policy
(sample from the policy generator), the twin's step, the truncation
bootstrap ``gamma * V(final_obs)`` for every truncated env, the step's
record, and the same-step autoreset (fresh states for every env drawn from
the env generator, kept where the env is done). Then the critic on the
last observation, GAE (``ops/math.py::gae``) and ``local_train`` on the
flattened rollout.

The env carry (the twin's state leaves flattened by path, the running
episode return and length, and ``theta`` for a scenario family) is a dict
of tensors updated in place, so a captured graph reads and writes the same
memory at every replay.

The recurrent superstep (:func:`make_recurrent_onpolicy_superstep_fn`)
carries the LSTM state and the previous actions through the rollout and
across updates in the same carry, and cuts the rollout into fixed windows
of ``seq_len`` steps for the sequence update.

Two generators, as the JAX package folds one key into two salted streams:
the policy's draws are the same in number every step, and so are the
env's (a reset draw for every env every step), so the policy stream never
depends on when an episode ends.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.envs.jittable import JittableEnvSpec
from sheeprl_tpu_torch.envs.variants import ScenarioFamily
from sheeprl_tpu_torch.ops.math import gae

# the salt of the env stream's seed (the JAX package's ENV_STREAM_SALT)
ENV_STREAM_SALT = 0x0E5E

Carry = Dict[str, torch.Tensor]


def flatten_state(state: Any, prefix: str = "state") -> Dict[str, torch.Tensor]:
    """A (nested) twin state as ``{"state/<path>": tensor}``."""
    if isinstance(state, dict):
        out: Dict[str, torch.Tensor] = {}
        for k, v in state.items():
            out.update(flatten_state(v, f"{prefix}/{k}"))
        return out
    return {prefix: state}


def unflatten_state(carry: Carry) -> Dict[str, Any]:
    """The twin state of a carry (the ``state/...`` entries)."""
    tree: Dict[str, Any] = {}
    for path, v in carry.items():
        parts = path.split("/")
        if parts[0] != "state":
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _spec_of(spec: Any, carry: Carry) -> JittableEnvSpec:
    return spec.instantiate(carry["theta"]) if isinstance(spec, ScenarioFamily) else spec


def init_env_carry(spec: Any, num_envs: int, generator: torch.Generator, thetas: Optional[torch.Tensor] = None) -> Carry:
    """Reset ``num_envs`` twin envs and build the carry: the state, the
    episode return and length accumulators (episodes span updates), and
    for a :class:`ScenarioFamily` the ``[E, P]`` scenario matrix (one row
    an env for its lifetime). The observation is not carried: it is a
    function of the state."""
    dev = generator.device
    carry: Carry = {}
    if isinstance(spec, ScenarioFamily):
        if thetas is None:
            raise ValueError("a ScenarioFamily carry needs the [E, P] theta matrix")
        if tuple(thetas.shape) != (num_envs, spec.param_dim):
            raise ValueError(f"theta matrix shape {tuple(thetas.shape)} != ({num_envs}, {spec.param_dim})")
        carry["theta"] = thetas.to(dev, torch.float32)
    elif thetas is not None:
        raise ValueError("theta matrix given but spec is not a ScenarioFamily")
    carry.update(flatten_state(_spec_of(spec, carry).init(generator, num_envs)))
    carry["ep_ret"] = torch.zeros(num_envs, device=dev)
    carry["ep_len"] = torch.zeros(num_envs, dtype=torch.int32, device=dev)
    return carry


def init_recurrent_env_carry(
    spec: Any, num_envs: int, generator: torch.Generator, hidden_size: int, action_dim: int, thetas: Optional[torch.Tensor] = None
) -> Carry:
    """:func:`init_env_carry` plus the recurrent player's state across
    updates (JAX :104-123): ``hx`` and ``cx [E, H]`` and the buffer-layout
    ``prev_actions [E, A]``, zeros."""
    carry = init_env_carry(spec, num_envs, generator, thetas)
    dev = generator.device
    carry["hx"] = torch.zeros(num_envs, hidden_size, device=dev)
    carry["cx"] = torch.zeros(num_envs, hidden_size, device=dev)
    carry["prev_actions"] = torch.zeros(num_envs, action_dim, device=dev)
    return carry


def make_onpolicy_superstep_fn(
    spec: Any,
    *,
    policy_fn: Callable,
    value_fn: Callable,
    local_train: Callable,
    obs_key: str,
    rollout_steps: int,
    gamma: float,
    gae_lambda: float,
    policy_generator: Optional[torch.Generator],
    env_generator: Optional[torch.Generator],
) -> Callable[[Carry, torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """The fused on-policy superstep: ``superstep(carry, coefs) ->
    (metrics, ep_stats)``.

    ``policy_fn(obs_dict, generator) -> (actions, real_actions, logprobs,
    values)`` is the agent's rollout head, ``value_fn(obs_dict) -> [E, 1]``
    its critic and ``local_train(data, coefs) -> metrics`` the update over
    the flattened ``[T * E, ...]`` rollout. ``carry`` is updated in place;
    ``ep_stats`` holds ``done``, ``ret`` (the return so far) and ``len``,
    each ``[T, E]``.
    """
    if rollout_steps <= 0:
        raise ValueError(f"rollout_steps must be positive, got {rollout_steps}")
    gamma, gae_lambda = float(gamma), float(gae_lambda)

    def superstep(carry: Carry, coefs: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        env = _spec_of(spec, carry)
        state = unflatten_state(carry)
        ep_ret, ep_len = carry["ep_ret"], carry["ep_len"]
        rows: Dict[str, list] = {k: [] for k in (obs_key, "dones", "values", "actions", "logprobs", "rewards", "ep_done", "ep_ret", "ep_len")}
        with torch.no_grad():
            for _ in range(rollout_steps):
                obs = env.observation(state)
                actions, real_actions, logprobs, values = policy_fn({obs_key: obs}, policy_generator)
                act = real_actions if env.is_continuous else real_actions[..., 0]
                next_state, out = env.step(state, act, env_generator)
                truncated = out.truncated.float()
                # the truncation bootstrap on the observation before the reset
                v_final = value_fn({obs_key: out.obs})
                reward = out.reward + gamma * v_final[:, 0] * truncated
                done = out.terminated | out.truncated
                ep_ret = ep_ret + out.reward
                ep_len = ep_len + 1
                for k, v in (
                    (obs_key, obs),
                    ("dones", done[:, None].float()),
                    ("values", values),
                    ("actions", actions),
                    ("logprobs", logprobs),
                    ("rewards", reward[:, None]),
                    ("ep_done", done),
                    ("ep_ret", ep_ret),
                    ("ep_len", ep_len),
                ):
                    rows[k].append(v)
                # same-step autoreset: done envs restart at once
                reset_state = env.init(env_generator, done.shape[0])
                state = _select(done, reset_state, next_state)
                ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
                ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
            data = {k: torch.stack(v) for k, v in rows.items()}
            ep_stats = {"done": data.pop("ep_done"), "ret": data.pop("ep_ret"), "len": data.pop("ep_len")}
            next_values = value_fn({obs_key: env.observation(state)})
            data["returns"], data["advantages"] = gae(
                data["rewards"], data["values"], data["dones"], next_values, gamma=gamma, gae_lambda=gae_lambda
            )
            for path, v in flatten_state(state).items():
                carry[path].copy_(v)
            carry["ep_ret"].copy_(ep_ret)
            carry["ep_len"].copy_(ep_len)
        flat = {k: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:]) for k, v in data.items()}
        return local_train(flat, coefs), ep_stats

    return superstep


def make_recurrent_onpolicy_superstep_fn(
    spec: Any,
    *,
    policy_fn: Callable,
    value_fn: Callable,
    local_train: Callable,
    obs_key: str,
    rollout_steps: int,
    seq_len: int,
    gamma: float,
    gae_lambda: float,
    reset_on_done: bool,
    policy_generator: Optional[torch.Generator],
    env_generator: Optional[torch.Generator],
) -> Callable[[Carry, torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """The fused superstep of recurrent PPO (JAX :291-503):
    ``superstep(carry, coefs) -> (metrics, ep_stats)``, with
    :func:`init_recurrent_env_carry`'s carry updated in place.

    ``policy_fn(obs [1, E, ...], prev_actions [1, E, A], hx, cx, generator)
    -> (actions, real_actions, logprobs, values, hx', cx')`` is the
    recurrent rollout head, time-major with one step; ``value_fn(obs,
    prev_actions, hx, cx) -> [1, E, 1]`` its critic. Each step stores the
    state before it (``prev_hx``, ``prev_cx``, ``prev_actions``); the
    truncation bootstrap runs the critic on the post-step state and the
    step's actions; then ``prev_actions = (1 - done) * actions`` and, with
    ``reset_on_done``, done envs restart the LSTM from zeros.

    The rollout is cut into ``W = rollout_steps / seq_len`` fixed windows,
    laid out ``[seq_len, W * E]`` with window ``w`` of env ``e`` at column
    ``w * E + e``; ``hx0``/``cx0`` are the stored states at the window
    starts and the mask is all ones. Windows may cross episode ends, so
    ``local_train(seq_data, hx0, cx0, coefs) -> metrics`` gets the stored
    ``dones`` and replays the resets (``evaluate_actions_resettable``).
    """
    if rollout_steps <= 0:
        raise ValueError(f"rollout_steps must be positive, got {rollout_steps}")
    if seq_len <= 0 or rollout_steps % seq_len != 0:
        raise ValueError(f"rollout_steps ({rollout_steps}) must be a positive multiple of seq_len ({seq_len})")
    gamma, gae_lambda = float(gamma), float(gae_lambda)
    keys = (obs_key, "dones", "values", "actions", "logprobs", "rewards", "prev_hx", "prev_cx", "prev_actions", "ep_done", "ep_ret", "ep_len")

    def superstep(carry: Carry, coefs: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        env = _spec_of(spec, carry)
        state = unflatten_state(carry)
        hx, cx, prev_actions = carry["hx"], carry["cx"], carry["prev_actions"]
        ep_ret, ep_len = carry["ep_ret"], carry["ep_len"]
        rows: Dict[str, list] = {k: [] for k in keys}
        with torch.no_grad():
            for _ in range(rollout_steps):
                obs = env.observation(state)
                actions, real_actions, logprobs, values, new_hx, new_cx = policy_fn(
                    {obs_key: obs[None]}, prev_actions[None], hx, cx, policy_generator
                )
                actions, real_actions, logprobs, values = actions[0], real_actions[0], logprobs[0], values[0]
                act = real_actions if env.is_continuous else real_actions[..., 0]
                next_state, out = env.step(state, act, env_generator)
                # the truncation bootstrap with the post-step state and this step's actions
                v_final = value_fn({obs_key: out.obs[None]}, actions[None], new_hx, new_cx)[0]
                reward = out.reward + gamma * v_final[:, 0] * out.truncated.float()
                done = out.terminated | out.truncated
                dones = done[:, None].float()
                ep_ret = ep_ret + out.reward
                ep_len = ep_len + 1
                for k, v in (
                    (obs_key, obs),
                    ("dones", dones),
                    ("values", values),
                    ("actions", actions),
                    ("logprobs", logprobs),
                    ("rewards", reward[:, None]),
                    ("prev_hx", hx),
                    ("prev_cx", cx),
                    ("prev_actions", prev_actions),
                    ("ep_done", done),
                    ("ep_ret", ep_ret),
                    ("ep_len", ep_len),
                ):
                    rows[k].append(v)
                reset_state = env.init(env_generator, done.shape[0])
                state = _select(done, reset_state, next_state)
                prev_actions = (1 - dones) * actions
                hx, cx = ((1 - dones) * new_hx, (1 - dones) * new_cx) if reset_on_done else (new_hx, new_cx)
                ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
                ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
            data = {k: torch.stack(v) for k, v in rows.items()}
            ep_stats = {"done": data.pop("ep_done"), "ret": data.pop("ep_ret"), "len": data.pop("ep_len")}
            next_values = value_fn({obs_key: env.observation(state)[None]}, prev_actions[None], hx, cx)[0]
            data["returns"], data["advantages"] = gae(
                data["rewards"], data["values"], data["dones"], next_values, gamma=gamma, gae_lambda=gae_lambda
            )
            for path, v in flatten_state(state).items():
                carry[path].copy_(v)
            for k, v in (("hx", hx), ("cx", cx), ("prev_actions", prev_actions), ("ep_ret", ep_ret), ("ep_len", ep_len)):
                carry[k].copy_(v)
        return local_train(*fixed_windows(data, seq_len), coefs), ep_stats

    return superstep


def fixed_windows(data: Dict[str, torch.Tensor], seq_len: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """A ``[T, E, ...]`` rollout holding ``prev_hx``/``prev_cx`` cut into
    ``W = T / seq_len`` windows: ``(seq, hx0, cx0)``, ``seq`` the other keys
    as ``[seq_len, W * E, ...]`` (window ``w`` of env ``e`` at column ``w * E
    + e``) with an all-ones ``mask``, ``hx0``/``cx0 [W * E, H]`` the stored
    states at the window starts (JAX :466-489)."""
    data = dict(data)
    t_len, num_envs = data["prev_hx"].shape[:2]
    num_windows = t_len // seq_len
    starts = lambda x: x.reshape(num_windows, seq_len, num_envs, -1)[:, 0].reshape(num_windows * num_envs, -1)  # noqa: E731
    hx0, cx0 = starts(data.pop("prev_hx")), starts(data.pop("prev_cx"))

    def to_seq(x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(num_windows, seq_len, *x.shape[1:]).transpose(0, 1)
        return x.reshape(seq_len, num_windows * num_envs, *x.shape[3:])

    seq = {k: to_seq(v) for k, v in data.items()}
    seq["mask"] = torch.ones(seq_len, num_windows * num_envs, 1, device=hx0.device)
    return seq, hx0, cx0


def _select(done: torch.Tensor, reset: Any, nxt: Any) -> Any:
    if isinstance(nxt, dict):
        return {k: _select(done, reset[k], v) for k, v in nxt.items()}
    return torch.where(done.reshape(done.shape + (1,) * (nxt.ndim - 1)), reset, nxt)
