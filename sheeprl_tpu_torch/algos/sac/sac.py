"""SAC training (port of ``sheeprl_tpu/algos/sac/sac.py``: ``make_train_fn``
:58-229 and ``main`` :231-648) on one device, and the off-policy loop the
SAC family shares (:func:`train_offpolicy`, which DroQ and SAC-AE run too).

One gradient step (:meth:`SACTrainer.step`, JAX :117-171) is, in this order:
the critic update against the target ensemble with ``alpha`` taken at the
start of the step, the target EMA (every ``max(1,
critic.target_network_frequency // num_envs)`` gradient steps, gated on the
device step counter), the actor update against the *updated* critics, then
the entropy coefficient; the logged alpha loss uses the updated
``log_alpha``. Everything is updated in place.

A train window of G steps (``Ratio`` sets G; its first call after the
warm-up repays the whole warm-up debt) runs as ``gradient_step_chunks``:
full chunks of ``algo.gradient_steps_chunk`` and a remainder. On the card
each chunk is one replay of a ``CapturedStep`` of that many steps, and the
remainder of r steps is r replays of the one-step graph (the steps are
sequential, so the arithmetic is the same): at most two captures a train
function. The train generator and the step counter live on the device
inside the graphs. Batches come from the replay path ``buffer.device``
picks: the host ``ReplayBuffer`` (each chunk's ``[n, B]`` sample copied
into the graph's inputs), the device ring (only the indices cross the bus)
or, with ``algo.fused_gradient_steps`` K > 0, draws inside the graph from
the ring (K steps a replay; the JAX ``fused_fallback`` fires on a host
buffer). The window's metrics are the gradient-step-weighted mean of its
replays'.

Checkpoints hold the JAX layout (``agent`` with ``actor``, ``critics``,
``target_critics`` and ``log_alpha`` as flax trees, the three optax states,
``ratio``, ``update``, ``batch_size``, ``last_log``, ``last_checkpoint``,
``rb`` with ``buffer.checkpoint``) and the generators' states; a run resumes
from the port's or the JAX package's. NaN rollback, the crash guard and the
preemption exit are wired as in PPO.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.convert import adam_from_optax, adam_to_optax
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _clock, _elapsed, random_actions, restore_generator, stream_seed
from sheeprl_tpu_torch.algos.ppo.ppo import start_run
from sheeprl_tpu_torch.algos.sac.agent import SACAgent, actor_action_and_log_prob, build_agent
from sheeprl_tpu_torch.algos.sac.convert import LOG_ALPHA, converter
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS, prepare_obs, test
from sheeprl_tpu_torch.data.device_buffer import (
    DeviceReplayBuffer,
    adapt_restored_buffer,
    copy_from_host_,
    draw_transition_batch,
    make_transition_replay,
)
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import Box
from sheeprl_tpu_torch.obs.heartbeat import log_sps_and_heartbeat
from sheeprl_tpu_torch.obs.telemetry import telemetry_advance, telemetry_run_metrics, telemetry_train_window
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.ops.optim import Adam, build_optimizer
from sheeprl_tpu_torch.ops.superstep import SAMPLE_KEY_SALT, fused_fallback, reset_fused_fallback_warnings
from sheeprl_tpu_torch.utils.checkpoint import elastic_per_rank_batch_size, select_buffer
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import Ratio, SteadyStateProbe, gradient_step_chunks, weighted_chunk_metrics

Batch = Dict[str, torch.Tensor]
# a batch key's item shape and dtype
BatchSpec = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def ema_(target: Sequence[torch.Tensor], source: Sequence[torch.Tensor], tau: float, gate: Optional[torch.Tensor] = None) -> None:
    """``target = tau * source + (1 - tau) * target`` in place (the JAX
    expression's products and sum), kept as it was where ``gate`` (a 0-d
    bool tensor) is false."""
    target = list(target)
    blend = torch._foreach_add(torch._foreach_mul(list(source), tau), torch._foreach_mul(target, 1 - tau))
    if gate is not None:
        blend = [torch.where(gate, b, t) for b, t in zip(blend, target)]
    torch._foreach_copy_(target, blend)


class OffPolicyTrainer:
    """What the off-policy loop asks of an algorithm: the gradient step, its
    state, the batch it reads, the replay layout and the checkpoint layout.
    This base runs a train window as captured graphs (:meth:`train_window`).

    ``step(batch, count)`` is one gradient step over a ``[B, ...]`` batch,
    in place, returning its metrics; ``count`` is the step's gradient
    counter as the host knows it, modulo :attr:`period` (a step whose gates
    depend on the counter reads them from it, so the graph of a chunk is
    keyed by its first step's phase); the step also adds one to the device
    counter :attr:`counter`."""

    metric_names: Tuple[str, ...] = ()
    # the gates' cycle in gradient steps: graphs are keyed by counter % period
    period: int = 1

    def __init__(self, cfg: Mapping[str, Any], device: torch.device, batch_size: int, fused_k: int) -> None:
        algo = cfg["algo"]
        self.device = device
        self.batch_size = int(batch_size)
        self.fused_k = int(fused_k)
        self.chunk = self.fused_k if self.fused_k > 0 else int(algo.get("gradient_steps_chunk", 16) or 16)
        self.sample_next_obs = bool(cfg["buffer"]["sample_next_obs"])
        seed = int(cfg["seed"])
        self.train_gen = torch.Generator(device=device).manual_seed(seed)
        self.sample_gen = torch.Generator(device=device).manual_seed(stream_seed(seed, SAMPLE_KEY_SALT))
        self.counter = torch.zeros((), dtype=torch.int32, device=device)
        self.grad_steps = 0  # the host's copy of the device counter
        self.graphs: Dict[Tuple[Any, ...], CapturedStep] = {}
        self.h2d_bytes = 0
        self.dispatches = 0

    # -- what an algorithm defines -------------------------------------------

    def step(self, batch: Batch, count: int) -> torch.Tensor:
        raise NotImplementedError

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes in place, the counter included."""
        raise NotImplementedError

    def batch_spec(self) -> BatchSpec:
        raise NotImplementedError

    # -- captured train functions ---------------------------------------------

    @property
    def captures(self) -> int:
        return sum(g.graph is not None for g in self.graphs.values())

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs.values())

    def _graph(self, length: int, phase: int, ring: Optional[Tuple[Batch, torch.Tensor, torch.Tensor]] = None) -> CapturedStep:
        """The captured train function of ``length`` steps from gate phase
        ``phase``: over static batch inputs, or with ``ring`` (the ring's
        ``superstep_inputs``) drawing its batches inside the graph."""
        fused = ring is not None
        key = ("fused" if fused else "batch", length, phase)
        if key in self.graphs:
            return self.graphs[key]
        generators: Tuple[torch.Generator, ...] = (self.train_gen,)
        if fused:
            bufs, pos, full = ring
            inputs: Batch = {"pos": pos, "full": full}
            generators += (self.sample_gen,)

            def batch_at(inp: Batch, i: int) -> Batch:
                return draw_transition_batch(
                    bufs, inp["pos"], inp["full"], self.sample_gen, self.batch_size, self.sample_next_obs, ("observations",)
                )

        else:
            inputs = {
                k: torch.zeros((length, self.batch_size, *shape), dtype=dtype, device=self.device)
                for k, (shape, dtype) in self.batch_spec().items()
            }

            def batch_at(inp: Batch, i: int) -> Batch:
                return {k: v[i] for k, v in inp.items()}

        def run(inp: Batch) -> torch.Tensor:
            rows = [self.step(batch_at(inp, i), (phase + i) % self.period) for i in range(length)]
            return torch.stack(rows).mean(0)

        # a chunk's warm-up runs all its steps: one call warms it up
        self.graphs[key] = CapturedStep(run, inputs, self.state_tensors(), generators, warmup=1 if length > 1 else 2)
        return self.graphs[key]

    def _sample(self, rb: Any, n: int) -> Dict[str, Any]:
        """``[n, B, ...]`` of the batch keys from the replay: device tensors
        from the ring, numpy from the host buffer."""
        if isinstance(rb, DeviceReplayBuffer):
            sample = rb.sample_transitions(self.batch_size, n_samples=n, sample_next_obs=self.sample_next_obs)
            self.h2d_bytes += n * self.batch_size * 4 * (3 if self.sample_next_obs else 2)
            return sample
        sample = rb.sample(self.batch_size, sample_next_obs=self.sample_next_obs, n_samples=n)
        out = {k: np.asarray(sample[k], dtype=np.uint8 if dt == torch.uint8 else np.float32) for k, (_, dt) in self.batch_spec().items()}
        self.h2d_bytes += sum(v.nbytes for v in out.values())
        return out

    @staticmethod
    def _fill(inputs: Batch, sample: Mapping[str, Any], rows: slice) -> None:
        for k, dst in inputs.items():
            src = sample[k][rows]
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
            else:
                copy_from_host_(dst, src)

    def train_window(self, rb: Any, n_steps: int) -> List[Tuple[int, torch.Tensor]]:
        """``n_steps`` gradient steps as chunk replays; returns ``(steps,
        metrics)`` of each replay (the metrics the mean over its steps)."""
        out: List[Tuple[int, torch.Tensor]] = []
        for n in gradient_step_chunks(n_steps, {"gradient_steps_chunk": self.chunk}):
            length = n if n == self.chunk else 1
            sample = ring = None
            if self.fused_k > 0:
                # the cursors, copied once into the ring's static tensors
                ring = rb.superstep_inputs(sample_next_obs=self.sample_next_obs)
                self.h2d_bytes += rb.n_envs * 5
            else:
                sample = self._sample(rb, n)
            for i in range(n // length):
                fn = self._graph(length, self.grad_steps % self.period, ring)
                if sample is not None:
                    self._fill(fn.inputs, sample, slice(i * length, (i + 1) * length))
                out.append((length, fn()))
                self.grad_steps += length
                self.dispatches += 1
        return out

    def window_metrics(self, chunks: List[Tuple[int, torch.Tensor]]) -> np.ndarray:
        """The window's :attr:`metric_names` values: the gradient-step
        weighted mean of its replays' metrics, in one fetch."""
        return weighted_chunk_metrics(chunks)

    # -- checkpoints -----------------------------------------------------------

    def ckpt_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_state(self, state: Mapping[str, Any]) -> None:
        raise NotImplementedError


class SACTrainer(OffPolicyTrainer):
    """SAC's gradient step (JAX ``make_train_fn``'s ``one_step``) and its
    optimizers (Adam for the critics, the actor and ``log_alpha``). The
    critics' dropout masks, where they have dropout (DroQ), come from
    :attr:`dropout_gen`."""

    metric_names = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")
    dropout_gen: Optional[torch.Generator] = None

    def __init__(self, agent: SACAgent, cfg: Mapping[str, Any], device: torch.device, batch_size: int, fused_k: int, obs_dim: int, act_dim: int) -> None:
        super().__init__(cfg, device, batch_size, fused_k)
        algo = cfg["algo"]
        self.agent = agent
        self.gamma = float(algo["gamma"])
        self.tau = float(algo["tau"])
        self.ema_every = max(1, int(algo["critic"]["target_network_frequency"]) // max(1, int(cfg["env"]["num_envs"])))
        # the SAC family's optimizers take no clipping
        self.critic_opt = build_optimizer(list(agent.critic.parameters()), algo["critic"]["optimizer"])
        self.actor_opt = build_optimizer(list(agent.actor.parameters()), algo["actor"]["optimizer"])
        self.alpha_opt = build_optimizer([agent.log_alpha], algo["alpha"]["optimizer"])
        self.obs_dim, self.act_dim = int(obs_dim), int(act_dim)

    def batch_spec(self) -> BatchSpec:
        f32 = torch.float32
        obs = ((self.obs_dim,), f32)
        return {"observations": obs, "next_observations": obs, "actions": ((self.act_dim,), f32), "rewards": ((1,), f32), "terminated": ((1,), f32)}

    def state_tensors(self) -> List[torch.Tensor]:
        opts = (self.critic_opt, self.actor_opt, self.alpha_opt)
        return [*self.agent.parameters(), *(t for o in opts for t in o.state_tensors()), self.counter]

    def critic_update(self, batch: Batch, alpha: torch.Tensor) -> torch.Tensor:
        agent, gen = self.agent, self.train_gen
        with torch.no_grad():
            next_actions, next_logpi = actor_action_and_log_prob(agent.actor, batch["next_observations"], gen)
            q_next = agent.target_critic(batch["next_observations"], next_actions, self.dropout_gen)
            min_q_next = q_next.min(-1, keepdim=True).values - alpha * next_logpi
            target = batch["rewards"] + (1 - batch["terminated"]) * self.gamma * min_q_next
        params = list(agent.critic.parameters())
        with torch.enable_grad():
            q = agent.critic(batch["observations"], batch["actions"], self.dropout_gen)
            qf_loss = critic_loss(q, target, agent.num_critics)
            grads = torch.autograd.grad(qf_loss, params)
        self.critic_opt.step(grads)
        return qf_loss.detach()

    def actor_and_alpha_update(self, obs: torch.Tensor, alpha: torch.Tensor, reduce: Callable[[torch.Tensor], torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The actor step against the current critics (``reduce`` folds
        their ``[B, n]`` Q values: the min for SAC, the mean for DroQ), then
        ``log_alpha``'s; returns the policy loss and the alpha loss at the
        updated ``log_alpha``."""
        agent = self.agent
        params = list(agent.actor.parameters())
        with torch.enable_grad():
            actions, logpi = actor_action_and_log_prob(agent.actor, obs, self.train_gen)
            q = agent.critic(obs, actions, self.dropout_gen)
            a_loss = policy_loss(alpha, logpi, reduce(q))
            grads = torch.autograd.grad(a_loss, params)
        self.actor_opt.step(grads)
        logpi = logpi.detach()
        with torch.enable_grad():
            alpha_grad = torch.autograd.grad(entropy_loss(agent.log_alpha, logpi, agent.target_entropy), [agent.log_alpha])
        self.alpha_opt.step(alpha_grad)
        return a_loss.detach(), entropy_loss(agent.log_alpha.detach(), logpi, agent.target_entropy)

    def step(self, batch: Batch, count: int) -> torch.Tensor:
        agent = self.agent
        alpha = agent.log_alpha.detach().exp()
        qf_loss = self.critic_update(batch, alpha)
        gate = None if self.ema_every == 1 else (self.counter % self.ema_every) == 0
        with torch.no_grad():
            ema_(list(agent.target_critic.parameters()), list(agent.critic.parameters()), self.tau, gate)
        a_loss, alpha_loss = self.actor_and_alpha_update(batch["observations"], alpha, lambda q: q.min(-1, keepdim=True).values)
        self.counter.add_(1)
        return torch.stack([qf_loss, a_loss, alpha_loss])

    def _optax(self) -> List[Tuple[str, Adam, torch.nn.Module]]:
        return [("qf_optimizer", self.critic_opt, self.agent.critic), ("actor_optimizer", self.actor_opt, self.agent.actor)]

    def ckpt_state(self) -> Dict[str, Any]:
        state = {"agent": self.agent.flax_state()}
        for key, opt, module in self._optax():
            state[key] = adam_to_optax(opt, [n for n, _ in module.named_parameters()], converter(module)[1])
        state["alpha_optimizer"] = adam_to_optax(self.alpha_opt, ["log_alpha"], LOG_ALPHA[1])
        return state

    @torch.no_grad()
    def load_state(self, state: Mapping[str, Any]) -> None:
        self.agent.load_flax_state(state["agent"])
        for key, opt, module in self._optax():
            adam_from_optax(state[key], opt, [n for n, _ in module.named_parameters()], converter(module)[0])
        adam_from_optax(state["alpha_optimizer"], self.alpha_opt, ["log_alpha"], LOG_ALPHA[0])


# --------------------------------------------------------------------------- #
# the off-policy loop
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class OffPolicyAlgorithm:
    """What SAC's, DroQ's and SAC-AE's loops differ in: ``build(cfg,
    obs_space, action_space, state, device, batch_size, fused_k) ->
    (trainer, player)``; of the run's config: the step dict the replay
    stores (``step_data(cfg)(obs, real_next_obs, actions, rewards,
    terminated, truncated, num_envs)``), the player's input of an
    observation (``player_obs(cfg)(obs, num_envs)``) and the replay's layout
    (the observation keys it stores, whether it stores the next
    observation, the keys that get a ``next_`` twin); the aggregator's keys
    and whether the CNN keys are dropped with a warning."""

    name: str
    build: Callable[..., Tuple[OffPolicyTrainer, Any]]
    step_data: Callable[[Mapping[str, Any]], Callable[..., Dict[str, np.ndarray]]]
    player_obs: Callable[[Mapping[str, Any]], Callable[[Mapping[str, np.ndarray], int], Any]]
    stored_keys: Callable[[Mapping[str, Any]], List[str]]
    store_next_obs: Callable[[Mapping[str, Any]], bool]
    rb_obs_keys: Callable[[Mapping[str, Any]], Tuple[str, ...]]
    aggregator_keys: frozenset
    vector_only: bool = False


def _vector_step_data(cfg: Mapping[str, Any], store_next: bool) -> Callable[..., Dict[str, np.ndarray]]:
    mlp_keys = list(cfg["algo"]["mlp_keys"]["encoder"])

    def step_data(obs, real_next_obs, actions, rewards, terminated, truncated, num_envs):
        out = {
            "terminated": np.asarray(terminated, np.float32).reshape(1, num_envs, 1),
            "truncated": np.asarray(truncated, np.float32).reshape(1, num_envs, 1),
            "actions": np.asarray(actions, np.float32).reshape(1, num_envs, -1),
            "observations": prepare_obs(obs, mlp_keys=mlp_keys, num_envs=num_envs)[np.newaxis],
        }
        if store_next:
            out["next_observations"] = prepare_obs(real_next_obs, mlp_keys=mlp_keys, num_envs=num_envs)[np.newaxis]
        out["rewards"] = np.asarray(rewards, np.float32).reshape(1, num_envs, 1)
        return out

    return step_data


def _check_vector_obs(cfg: Mapping[str, Any], obs_space: Any, name: str) -> List[str]:
    mlp_keys = list(cfg["algo"]["mlp_keys"]["encoder"])
    if len(mlp_keys) == 0:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    for k in mlp_keys:
        if len(obs_space[k].shape) > 1:
            raise ValueError(
                f"Only environments with vector-only observations are supported by the {name} agent. "
                f"The observation with key '{k}' has shape {obs_space[k].shape}."
            )
    return mlp_keys


def build_sac(cfg, obs_space, action_space, state, device, batch_size, fused_k):
    mlp_keys = _check_vector_obs(cfg, obs_space, "SAC")
    agent, player = build_agent(cfg, obs_space, action_space, state["agent"] if state else None, device=device)
    obs_dim = int(sum(np.prod(obs_space[k].shape) for k in mlp_keys))
    trainer = SACTrainer(agent, cfg, device, batch_size, fused_k, obs_dim, int(np.prod(action_space.shape)))
    return trainer, player


def vector_algorithm(name: str, build: Callable[..., Any], store_next_obs: Callable[[Mapping[str, Any]], bool], vector_only: bool) -> OffPolicyAlgorithm:
    """SAC's and DroQ's loop: vector observations, stored as one
    ``observations`` row (and ``next_observations`` unless
    ``store_next_obs`` says the replay samples it)."""
    return OffPolicyAlgorithm(
        name=name,
        build=build,
        step_data=lambda cfg: _vector_step_data(cfg, store_next_obs(cfg)),
        player_obs=lambda cfg: (lambda obs, n: prepare_obs(obs, mlp_keys=cfg["algo"]["mlp_keys"]["encoder"], num_envs=n)),
        stored_keys=lambda cfg: list(cfg["algo"]["mlp_keys"]["encoder"]),
        store_next_obs=store_next_obs,
        rb_obs_keys=lambda cfg: ("observations",),
        aggregator_keys=frozenset(AGGREGATOR_KEYS),
        vector_only=vector_only,
    )


SAC = vector_algorithm("SAC", build_sac, lambda cfg: not bool(cfg["buffer"]["sample_next_obs"]), vector_only=True)


def _final_obs(next_obs: Mapping[str, np.ndarray], infos: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The observation each env reached, its episode's final one where it
    ended (JAX :476-481)."""
    real = {k: np.asarray(v).copy() for k, v in next_obs.items()}
    if "final_obs" in infos:
        for idx, final in enumerate(infos["final_obs"]):
            if final is not None:
                for k, v in final.items():
                    real[k][idx] = v
    return real


def train_offpolicy(fabric: Any, cfg: Optional[Dict[str, Any]], device: DeviceLike, algorithm: OffPolicyAlgorithm) -> Dict[str, Any]:
    """The SAC family's loop (``main``'s contract; JAX ``sac.py:231-648``):
    the vector env, the transition replay ``buffer.device`` picks, random
    actions up to ``algo.learning_starts``, then each update one env step
    of the player, ``Ratio``'s gradient steps as a train window, the
    metrics, the checkpoints, and a greedy test episode at the end."""
    fabric, cfg, state, log_dir, logger, callback, resil = start_run(fabric, cfg, device, algorithm.vector_only)
    ckpt_cfg, buffer_cfg, algo = cfg["checkpoint"], cfg["buffer"], cfg["algo"]
    dev = fabric.device
    seed = int(cfg["seed"])
    num_envs = int(cfg["env"]["num_envs"])
    dry_run = bool(cfg["dry_run"])

    envs = build_vector_env(cfg, 0, log_dir, "train")
    action_space, observation_space = envs.single_action_space, envs.single_observation_space
    if not isinstance(action_space, Box):
        envs.close()
        raise ValueError(f"Only continuous action space is supported for the {algorithm.name} agent")

    batch_size = int(algo["per_rank_batch_size"])
    if state is not None:
        batch_size = elastic_per_rank_batch_size(int(state["batch_size"]), 1)
    fused_k = int(algo.get("fused_gradient_steps", 0) or 0)
    buffer_size = int(buffer_cfg["size"]) // num_envs if not dry_run else 1
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0")
    rb = make_transition_replay(
        cfg,
        dev,
        observation_space,
        algorithm.stored_keys(cfg),
        action_space.shape,
        buffer_size,
        num_envs,
        algorithm.rb_obs_keys(cfg),
        memmap_dir,
        seed,
        algorithm.store_next_obs(cfg),
    )
    use_device_rb = isinstance(rb, DeviceReplayBuffer)
    if state is not None and buffer_cfg["checkpoint"]:
        rb = adapt_restored_buffer(
            select_buffer(state["rb"], 0, 1), use_device_rb, seed=seed, memmap=bool(buffer_cfg["memmap"]), memmap_dir=memmap_dir, device=dev, mode="transition"
        )
    # fused supersteps draw inside the graph from the ring (JAX :329-353)
    reset_fused_fallback_warnings()
    if fused_k > 0 and not use_device_rb:
        fused_fallback(
            "host_buffer",
            "algo.fused_gradient_steps needs the device replay buffer (buffer.device) to draw batches inside "
            "the captured chunk; falling back to the per-chunk host gather.",
        )
        fused_k = 0

    trainer, player = algorithm.build(cfg, observation_space, action_space, state, dev, batch_size, fused_k)
    step_data_fn = algorithm.step_data(cfg)
    player_obs = algorithm.player_obs(cfg)

    policy_steps_per_update = num_envs
    start_step = int(state["update"]) + 1 if state is not None else 1
    policy_step = int(state["update"]) * policy_steps_per_update if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    num_updates = int(algo["total_steps"]) // policy_steps_per_update if not dry_run else 1
    learning_starts = int(algo["learning_starts"]) // policy_steps_per_update if not dry_run else 0
    if state is not None and not buffer_cfg["checkpoint"]:
        learning_starts += start_step
    ratio = Ratio(float(algo["replay_ratio"]), pretrain_steps=int(algo["per_rank_pretrain_steps"]))
    player_gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1))
    if state is not None:
        trainer.load_state(state)
        ratio.load_state_dict(state["ratio"])
        restore_generator(trainer.train_gen, state.get("rng_key"), seed, start_step - 1)
        restore_generator(player_gen, state.get("player_rng_key"), seed, start_step - 1, 1)
    action_rng = np.random.default_rng(seed)

    metric_cfg = cfg["metric"]
    log_level, log_every = int(metric_cfg["log_level"]), int(metric_cfg["log_every"])
    aggregator = build_aggregator(cfg, algorithm.aggregator_keys)

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        return {
            **trainer.ckpt_state(),
            "ratio": ratio.state_dict(),
            "update": completed_update,
            "batch_size": batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": trainer.train_gen.get_state().numpy(),
            "player_rng_key": player_gen.get_state().numpy(),
        }

    def ckpt_path_fn(step: int) -> str:
        return os.path.join(log_dir, "checkpoint", f"ckpt_{step}_0.ckpt")

    def buffer_to_save() -> Any:
        return rb if buffer_cfg["checkpoint"] else None

    def rollback(at_update: int) -> None:
        restored = resil.rollback(update=at_update)
        trainer.load_state(restored)
        if "rng_key" in restored:
            restore_generator(trainer.train_gen, restored["rng_key"], seed, int(restored["update"]))
        resil.resalt_key(trainer.train_gen)

    obs, _ = envs.reset(seed=seed)
    update = start_step
    updates_run = 0
    preempted = False
    train_windows = last_train = 0
    gradient_steps = 0
    windows: List[Tuple[Any, Any]] = []
    wall: List[float] = []
    env_seconds = 0.0
    window_metrics: Optional[np.ndarray] = None
    probe = SteadyStateProbe()
    resil.arm_crash_guard(path_fn=lambda: ckpt_path_fn(policy_step), state_fn=lambda: ckpt_state_fn(update - 1), replay_buffer_fn=buffer_to_save)
    t_start = time.perf_counter()
    try:
        for update in range(start_step, num_updates + 1):
            telemetry_advance(policy_step)
            if resil.preempt_requested():
                last_checkpoint = policy_step
                resil.emergency_checkpoint(ckpt_path_fn(policy_step), ckpt_state_fn(update - 1), buffer_to_save())
                preempted = True
                break
            probe.mark_warm(update, learning_starts, policy_step, work=gradient_steps)
            updates_run += 1
            t_update = time.perf_counter()
            policy_step += policy_steps_per_update
            with timer("Time/env_interaction_time"):
                if update <= learning_starts:
                    actions, _ = random_actions(action_rng, action_space, action_space.shape, num_envs)
                else:
                    actions = player.get_actions(player_obs(obs, num_envs), player_gen)
                next_obs, rewards, terminated, truncated, infos = envs.step(np.asarray(actions).reshape(num_envs, *action_space.shape))
            env_seconds += time.perf_counter() - t_update
            if log_level > 0 and "final_info" in infos:
                ep = infos["final_info"].get("episode")
                if ep is not None:
                    for i in np.nonzero(ep.get("_r", []))[0]:
                        aggregator.update("Rewards/rew_avg", float(ep["r"][i]))
                        aggregator.update("Game/ep_len_avg", float(ep["l"][i]))
                        print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep['r'][i]}")
            data = step_data_fn(obs, _final_obs(next_obs, infos), actions, rewards, terminated, truncated, num_envs)
            rb.add(data, validate_args=bool(buffer_cfg["validate_args"]))
            obs = next_obs

            if update >= learning_starts:
                n_steps = ratio(policy_step)
                if n_steps > 0:
                    dispatches = trainer.dispatches
                    with timer("Time/train_time"):
                        start = _clock(dev)
                        chunks = trainer.train_window(rb, n_steps)
                        windows.append((start, _clock(dev)))
                        window_metrics = trainer.window_metrics(chunks)
                    gradient_steps += sum(s for s, _ in chunks)
                    train_windows += 1
                    telemetry_train_window(trainer.dispatches - dispatches, sum(s for s, _ in chunks))
                    if resil.finite_checks and not resil.check_finite(window_metrics, update):
                        rollback(update)
                        wall.append(time.perf_counter() - t_update)
                        continue
                    if log_level > 0:
                        for name, value in zip(trainer.metric_names, window_metrics):
                            aggregator.update(name, float(value))
            wall.append(time.perf_counter() - t_update)

            if log_level > 0 and (policy_step - last_log >= log_every or update == num_updates):
                metrics_dict = aggregator.compute()
                logger.log_metrics(metrics_dict, policy_step)
                telemetry_run_metrics(metrics_dict)
                aggregator.reset()
                if policy_step > 0:
                    logger.log_metrics({"Params/replay_ratio": gradient_steps / policy_step}, policy_step)
                log_sps_and_heartbeat(
                    logger,
                    policy_step=policy_step,
                    env_steps=(policy_step - last_log) * int(cfg["env"]["action_repeat"]),
                    train_steps=train_windows - last_train,
                )
                last_log = policy_step
                last_train = train_windows
            if (int(ckpt_cfg["every"]) > 0 and policy_step - last_checkpoint >= int(ckpt_cfg["every"])) or (
                update == num_updates and ckpt_cfg["save_last"]
            ):
                last_checkpoint = policy_step
                callback.on_checkpoint_coupled(ckpt_path_fn(policy_step), ckpt_state_fn(update), buffer_to_save())
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
    probe.finish(policy_step, sync=(lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None, work=gradient_steps)
    envs.close()
    test_reward, test_steps = None, 0
    if algo.get("run_test", True) and not preempted:
        test_reward, test_steps = test(player, cfg, lambda o: player_obs(o, 1), log_dir, logger=logger)
    logger.finalize()
    resil.close()
    if preempted:
        resil.exit_preempted()
    if use_device_rb:
        replay = "device"
    else:
        replay = "memmap" if rb.is_memmap else "host"
    return {
        "log_dir": log_dir,
        "start_update": start_step,
        "updates": updates_run,
        "env_steps": policy_step,
        "gradient_steps": gradient_steps,
        "train_windows": train_windows,
        "seconds": seconds,
        "env_seconds": env_seconds,
        "window_seconds": [_elapsed(a, b) for a, b in windows],
        "update_wall_seconds": wall,
        "learning_starts": learning_starts,
        "metrics": {} if window_metrics is None else dict(zip(trainer.metric_names, map(float, window_metrics))),
        "rollbacks": resil.rollbacks,
        "last_checkpoint": last_checkpoint,
        "replay_buffer": replay,
        "fused_gradient_steps": trainer.fused_k,
        "captures": trainer.captures,
        "replays": trainer.replays,
        "h2d_bytes": trainer.h2d_bytes,
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train SAC, called as the CLI calls it, ``main(fabric, cfg)``, or as
    ``main(cfg, device=...)`` on ``device`` (the CUDA card unless
    ``device="cpu"``), for ``algo.total_steps`` env steps (one update with
    ``dry_run``). Returns the run's counts, seconds, metrics, captures and
    replays."""
    return train_offpolicy(fabric, cfg, device, SAC)
