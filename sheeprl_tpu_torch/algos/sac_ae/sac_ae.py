"""SAC-AE training (port of ``sheeprl_tpu/algos/sac_ae/sac_ae.py``:
``make_train_fn`` :51-243 and ``main`` :246-606) on one device, in SAC's
off-policy loop (``algos/sac/sac.py::train_offpolicy``).

One gradient step (:meth:`SACAETrainer.step`, JAX :102-229), in order:

1. the critic update: the TD target from the target encoder and target Q
   ensemble, the next action from the online encoder and the actor; the
   critic loss trains the Q ensemble (its Adam) and the encoder (the
   encoder's Adam);
2. the target EMA of the Q ensemble (``tau``) and the encoder
   (``encoder.tau``) every ``critic.per_rank_target_network_update_freq``
   steps;
3. every ``actor.per_rank_update_freq`` steps, the actor and alpha update
   on the encoder's features with the gradient stopped at the conv trunk;
4. every ``decoder.per_rank_update_freq`` steps, the reconstruction loss
   (the 5-bit quantized pixels, no noise, plus ``decoder.l2_lambda`` times
   the latent's squared norm) trains the decoder (its AdamW, decoupled
   weight decay as optax's ``adamw``) and the encoder again, through the
   *same* encoder Adam: its step count advances twice in such a step.

The JAX step gates 2-4 with ``lax.cond``/``where`` on the step counter. Here
the gates are chosen on the host, where the counter is known: a captured
chunk is keyed by its first step's phase (the counter modulo the gates'
least common multiple), so a skipped update is not in the graph at all and
leaves the parameters and the optimizer states exactly as they were (four
captures at the published settings: two phases of the chunk and of the
single step). Pixels stay uint8 in the replay and cross the bus as uint8;
they are folded and divided by 255 inside the step. ``main`` forces
``env.screen_size = 64`` (JAX :256).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.convert import adam_from_optax, adam_to_optax
from sheeprl_tpu_torch.algos.sac.agent import actor_action_and_log_prob
from sheeprl_tpu_torch.algos.sac.convert import LOG_ALPHA, converter
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.sac import Batch, BatchSpec, OffPolicyAlgorithm, OffPolicyTrainer, ema_, train_offpolicy
from sheeprl_tpu_torch.algos.sac_ae.agent import SACAEAgent, build_agent, encoder_inputs, fold_frames
from sheeprl_tpu_torch.algos.sac_ae.utils import AGGREGATOR_KEYS, prepare_obs, preprocess_target
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.ops.optim import build_optimizer
from sheeprl_tpu_torch.parallel.fabric import Fabric
from sheeprl_tpu_torch.utils.registry import register_algorithm

SCREEN_SIZE = 64


class SACAETrainer(OffPolicyTrainer):
    """SAC-AE's gradient step and its five optimizers."""

    metric_names = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss")

    def __init__(self, agent: SACAEAgent, cfg: Mapping[str, Any], device: torch.device, batch_size: int, obs_space: Any, act_dim: int) -> None:
        super().__init__(cfg, device, batch_size, 0)
        algo = cfg["algo"]
        self.agent = agent
        self.gamma = float(algo["gamma"])
        self.l2_lambda = float(algo["decoder"]["l2_lambda"])
        self.cnn_keys, self.mlp_keys = tuple(algo["cnn_keys"]["encoder"]), tuple(algo["mlp_keys"]["encoder"])
        self.cnn_dec_keys, self.mlp_dec_keys = tuple(algo["cnn_keys"]["decoder"]), tuple(algo["mlp_keys"]["decoder"])
        self.target_freq = max(1, int(algo["critic"]["per_rank_target_network_update_freq"]))
        self.actor_freq = max(1, int(algo["actor"]["per_rank_update_freq"]))
        self.decoder_freq = max(1, int(algo["decoder"]["per_rank_update_freq"]))
        self.period = math.lcm(self.target_freq, self.actor_freq, self.decoder_freq)
        self.qf_opt = build_optimizer(list(agent.qf.parameters()), algo["critic"]["optimizer"])
        self.actor_opt = build_optimizer(list(agent.actor.parameters()), algo["actor"]["optimizer"])
        self.alpha_opt = build_optimizer([agent.log_alpha], algo["alpha"]["optimizer"])
        self.encoder_opt = build_optimizer(list(agent.encoder.parameters()), algo["encoder"]["optimizer"])
        self.decoder_opt = build_optimizer(list(agent.decoder.parameters()), algo["decoder"]["optimizer"])
        self.obs_space, self.act_dim = obs_space, int(act_dim)

    def batch_spec(self) -> BatchSpec:
        f32 = torch.float32
        spec: BatchSpec = {}
        for k in self.cnn_keys + self.mlp_keys:
            item = (tuple(self.obs_space[k].shape), torch.uint8 if k in self.cnn_keys else f32)
            spec[k] = spec[f"next_{k}"] = item
        spec.update(actions=((self.act_dim,), f32), rewards=((1,), f32), terminated=((1,), f32))
        return spec

    def _optimizers(self):
        return (self.qf_opt, self.actor_opt, self.alpha_opt, self.encoder_opt, self.decoder_opt)

    def state_tensors(self) -> List[torch.Tensor]:
        return [*self.agent.parameters(), *(t for o in self._optimizers() for t in o.state_tensors()), self.counter]

    def step(self, batch: Batch, count: int) -> torch.Tensor:
        agent, gen = self.agent, self.train_gen
        alpha = agent.log_alpha.detach().exp()
        obs = encoder_inputs(batch, self.cnn_keys, self.mlp_keys)
        next_obs = encoder_inputs(batch, self.cnn_keys, self.mlp_keys, "next_")
        zero = torch.zeros((), device=self.device)

        # the critic (+ encoder) update (JAX :115-140)
        with torch.no_grad():
            next_feat = agent.target_encoder(next_obs)
            next_actions, next_logpi = actor_action_and_log_prob(agent.actor, agent.encoder(next_obs), gen)
            q_next = agent.target_qf(next_feat, next_actions)
            min_q_next = q_next.min(-1, keepdim=True).values - alpha * next_logpi
            target = batch["rewards"] + (1 - batch["terminated"]) * self.gamma * min_q_next
        qf_params, enc_params = list(agent.qf.parameters()), list(agent.encoder.parameters())
        with torch.enable_grad():
            q = agent.qf(agent.encoder(obs), batch["actions"])
            qf_loss = critic_loss(q, target, agent.num_critics)
            grads = torch.autograd.grad(qf_loss, qf_params + enc_params)
        self.qf_opt.step(grads[: len(qf_params)])
        self.encoder_opt.step(grads[len(qf_params) :])

        # the target EMA (JAX :142-152)
        if count % self.target_freq == 0:
            with torch.no_grad():
                ema_(list(agent.target_qf.parameters()), qf_params, agent.tau)
                ema_(list(agent.target_encoder.parameters()), enc_params, agent.encoder_tau)

        # the actor + alpha update on detached features (JAX :154-191)
        a_loss = alpha_loss = zero
        if count % self.actor_freq == 0:
            actor_params = list(agent.actor.parameters())
            with torch.no_grad():
                feat = agent.encoder(obs, detach=True)
            with torch.enable_grad():
                actions, logpi = actor_action_and_log_prob(agent.actor, feat, gen)
                min_q = agent.qf(feat, actions).min(-1, keepdim=True).values
                a_loss = policy_loss(alpha, logpi, min_q)
                actor_grads = torch.autograd.grad(a_loss, actor_params)
            self.actor_opt.step(actor_grads)
            logpi = logpi.detach()
            with torch.enable_grad():
                alpha_grad = torch.autograd.grad(entropy_loss(agent.log_alpha, logpi, agent.target_entropy), [agent.log_alpha])
            self.alpha_opt.step(alpha_grad)
            a_loss, alpha_loss = a_loss.detach(), entropy_loss(agent.log_alpha.detach(), logpi, agent.target_entropy)

        # the decoder (+ encoder) update (JAX :193-220)
        rec_loss = zero
        if count % self.decoder_freq == 0:
            dec_params = list(agent.decoder.parameters())
            with torch.enable_grad():
                hidden = agent.encoder(obs)
                recon = agent.decoder(hidden)
                rec_loss = self.l2_lambda * torch.mean(0.5 * hidden.square().sum(-1))
                for k in self.cnn_dec_keys:
                    want = preprocess_target(fold_frames(batch[k])).permute(0, 3, 1, 2)
                    rec_loss = rec_loss + torch.mean(torch.square(want - recon[k]))
                for k in self.mlp_dec_keys:
                    rec_loss = rec_loss + torch.mean(torch.square(batch[k].float() - recon[k]))
                grads = torch.autograd.grad(rec_loss, enc_params + dec_params)
            self.encoder_opt.step(grads[: len(enc_params)])
            self.decoder_opt.step(grads[len(enc_params) :])
            rec_loss = rec_loss.detach()
        self.counter.add_(1)
        return torch.stack([qf_loss.detach(), a_loss, alpha_loss, rec_loss])

    # -- checkpoints (JAX :570-596) ---------------------------------------------

    def _optax(self):
        a = self.agent
        return (
            ("qf_optimizer", self.qf_opt, a.qf),
            ("actor_optimizer", self.actor_opt, a.actor),
            ("encoder_optimizer", self.encoder_opt, a.encoder),
            ("decoder_optimizer", self.decoder_opt, a.decoder),
        )

    def ckpt_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {"agent": self.agent.flax_state()}
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


def build_sac_ae(cfg, obs_space, action_space, state, device, batch_size, fused_k):
    algo = cfg["algo"]
    if not list(algo["cnn_keys"]["encoder"]) + list(algo["mlp_keys"]["encoder"]):
        raise RuntimeError(
            "You should specify at least one CNN key or MLP key from the cli: "
            "`algo.cnn_keys.encoder=[rgb]` or `algo.mlp_keys.encoder=[state]`"
        )
    agent, player = build_agent(cfg, obs_space, action_space, state["agent"] if state else None, device=device)
    return SACAETrainer(agent, cfg, device, batch_size, obs_space, int(np.prod(action_space.shape))), player


def _obs_keys(cfg: Mapping[str, Any]) -> List[str]:
    return list(cfg["algo"]["cnn_keys"]["encoder"]) + list(cfg["algo"]["mlp_keys"]["encoder"])


def _step_data(cfg: Mapping[str, Any]):
    cnn_keys = set(cfg["algo"]["cnn_keys"]["encoder"])
    keys = _obs_keys(cfg)

    def step_data(obs, real_next_obs, actions, rewards, terminated, truncated, num_envs):
        # pixels stored raw uint8, vectors fp32 (JAX :500-517)
        out: Dict[str, np.ndarray] = {}
        for k in keys:
            for name, src in ((k, obs), (f"next_{k}", real_next_obs)):
                v = np.asarray(src[k]) if k in cnn_keys else np.asarray(src[k], np.float32)
                out[name] = v.reshape(1, num_envs, *v.shape[1:])
        out["terminated"] = np.asarray(terminated, np.float32).reshape(1, num_envs, 1)
        out["truncated"] = np.asarray(truncated, np.float32).reshape(1, num_envs, 1)
        out["actions"] = np.asarray(actions, np.float32).reshape(1, num_envs, -1)
        out["rewards"] = np.asarray(rewards, np.float32).reshape(1, num_envs, 1)
        return out

    return step_data


SAC_AE = OffPolicyAlgorithm(
    name="SAC-AE",
    build=build_sac_ae,
    step_data=_step_data,
    player_obs=lambda cfg: (lambda obs, n: prepare_obs(obs, cfg["algo"]["cnn_keys"]["encoder"], cfg["algo"]["mlp_keys"]["encoder"], n)),
    stored_keys=_obs_keys,
    store_next_obs=lambda cfg: True,
    rb_obs_keys=lambda cfg: tuple(_obs_keys(cfg)) + tuple(f"next_{k}" for k in _obs_keys(cfg)),
    aggregator_keys=frozenset(AGGREGATOR_KEYS),
)


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train SAC-AE, called as the CLI calls it, ``main(fabric, cfg)``, or as
    ``main(cfg, device=...)``; SAC's ``main`` contract and report. The
    frames are ``SCREEN_SIZE`` pixels a side, whatever ``env.screen_size``
    says (JAX :256)."""
    run_cfg = cfg if isinstance(fabric, Fabric) else fabric
    run_cfg["env"]["screen_size"] = SCREEN_SIZE
    return train_offpolicy(fabric, cfg, device, SAC_AE)
