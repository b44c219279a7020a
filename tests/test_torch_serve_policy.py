"""The served PPO forward, the port's against the JAX package's, on the
CPU: a JAX PPO agent built from a seed (its weights shifted by seeded
noise) is saved as a committed JAX checkpoint with its manifest, then
served through the JAX ``build_ppo_policy`` + ``CompiledLadder.run`` and
through the port's builder + ladder (``ModelStore``: its rungs run the eager
forward on the CPU), on 64 seeded observations at each rung of the ladder
(one case a rung).
Discrete (CartPole-v1), continuous (Pendulum-v1) and NatureCNN (PixelCatcher)
policies at small widths.

Bounds: at fp32 discrete actions are equal and continuous ones within 1e-5.
At bf16-mixed continuous actions are within 16 x 2^-8 (the bound
tests/test_torch_precision.py holds bf16 gradients to); discrete actions are
equal wherever the two largest logits (the port's, in fp32 after the bf16
head) are more than 2^-6 apart, and the test counts the others, where a
bf16 rounding may flip the argmax.
"""

import jax
import numpy as np
import pytest

from sheeprl_tpu.algos.ppo import agent as jagent
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.envs import make_env as jax_make_env
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.resilience.manifest import build_manifest as jax_build_manifest
from sheeprl_tpu.serve.model import CompiledLadder as JaxLadder
from sheeprl_tpu.serve.policy import build_ppo_policy as jax_build_ppo_policy
from sheeprl_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch.algos.ppo.convert import agent_from_flax
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.serve.loadgen import random_obs
from sheeprl_tpu_torch.serve.model import ModelStore
from sheeprl_tpu_torch.serve.policy import build_served_policy
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict

LADDER = [1, 2, 4, 8]
N_OBS = 64
FP32_TOL = 1e-5
BF16_TOL = 16 * 2.0**-8
BF16_GAP = 2.0**-6

SMALL = [
    "algo.encoder.dense_units=16",
    "algo.encoder.mlp_features_dim=8",
    "algo.encoder.cnn_features_dim=32",
    "algo.actor.dense_units=16",
    "algo.critic.dense_units=16",
    "env.capture_video=False",
    "seed=7",
]
ENVS = {
    "cartpole_discrete": ["exp=ppo"],
    "pendulum_continuous": ["exp=ppo", "env.id=Pendulum-v1"],
    "pixel_catcher_nature_cnn": ["exp=ppo_atari", "env=pixel_catcher", "env.id=pixel_catcher"],
}


@pytest.fixture(scope="module", params=list(ENVS))
def env_checkpoint(request, tmp_path_factory):
    """``(env, path)`` of a committed JAX PPO checkpoint (payload + manifest)
    of seeded, noise-shifted weights, written once for each env: the params
    are fp32 at both precisions, so every case of that env serves one file."""
    env = request.param
    cfg = jdotdict(jax_compose("config", [*ENVS[env], *SMALL]).to_dict())
    made = jax_make_env(cfg, cfg.seed, 0, None, "serve", vector_env_idx=0)()
    space, act = made.observation_space, made.action_space
    made.close()
    cont = hasattr(act, "low")
    dims = tuple(act.shape) if cont else (int(act.n),)
    fabric = JaxFabric(devices=1, precision=cfg.fabric.precision, accelerator="cpu")
    _, params = jagent.build_agent(fabric, dims, cont, cfg, space)
    rng = np.random.default_rng(0)
    shift = lambda x: np.asarray(x, np.float32) + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)  # noqa: E731
    state = {"agent": jax.tree.map(shift, jax.device_get(params)), "update": 3}
    path = str(tmp_path_factory.mktemp(env) / "ckpt_96_0.ckpt")
    man = jax_build_manifest(step=96, backend="pickle", world_size=1, state=state)
    jax_save_checkpoint(path, state, backend="pickle", manifest=man)
    return env, path


def served_pair(path, env, precision):
    overrides = [*ENVS[env], *SMALL, f"fabric.precision={precision}"]
    jpolicy = jax_build_ppo_policy(jdotdict(jax_compose("config", overrides).to_dict()), jax_load_checkpoint(path))
    cfg = dotdict(compose("config", overrides))
    policy = build_served_policy(cfg, load_checkpoint(path), device="cpu")
    return jpolicy, policy, cfg


def serve_all(serve_one, obs, rung):
    """The answers to the 64 observations, served in batches of ``rung``."""
    return np.concatenate([np.stack(serve_one(obs[i : i + rung])) for i in range(0, len(obs), rung)])


def logit_gaps(cfg, path, policy, obs):
    """The gap between the two largest logits of each observation: the
    port's agent on the checkpoint's weights at the served precision, its
    head read in fp32."""
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims
    from sheeprl_tpu_torch.serve.model import stack_obs

    env = make_env(cfg, cfg.seed, 0, None, "serve")()
    space, (dims, cont) = env.observation_space, action_dims(env.action_space)
    env.close()
    agent, _ = build_agent(dims, cont, cfg, space, agent_from_flax(load_checkpoint(path)["agent"]), device="cpu")
    batch = stack_obs(policy.obs_spec, obs, len(obs))
    with torch.inference_mode():
        heads, _ = agent({k: torch.from_numpy(v) for k, v in batch.items()})
    top = torch.topk(heads[0].float(), 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).numpy()


@pytest.mark.parametrize("rung", LADDER)
@pytest.mark.parametrize("precision", ["32-true", "bf16-mixed"])
def test_served_ppo_forward_matches_jax(env_checkpoint, precision, rung):
    """One rung of the ladder ``[1, 2, 4, 8]`` a case (each ladder built
    with that rung, so a case compiles one JAX executable)."""
    env, path = env_checkpoint
    jpolicy, policy, cfg = served_pair(path, env, precision)
    assert {k: (tuple(s.shape), np.dtype(s.dtype)) for k, s in jpolicy.obs_spec.items()} == policy.obs_spec
    make, rng = random_obs(policy.obs_spec), np.random.default_rng(0)
    obs = [make(rng) for _ in range(N_OBS)]
    jladder = JaxLadder(jpolicy, [rung])
    ladder = ModelStore(policy, [rung], step=96, path=path, slots=1).current.ladders[0]
    want = serve_all(lambda o: jladder.run(jpolicy.params, o), obs, rung)
    got = serve_all(ladder.run, obs, rung)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_TOL if precision == "32-true" else BF16_TOL)
    elif precision == "32-true":
        np.testing.assert_array_equal(got, want)
    else:
        clear = logit_gaps(cfg, path, policy, obs) > BF16_GAP
        np.testing.assert_array_equal(got[clear], want[clear])
        near_ties = int((~clear).sum())
        print(f"{env} rung {rung}: {near_ties} of {N_OBS} observations within 2^-6 of a tie")
        assert near_ties <= N_OBS // 4  # the check still holds most actions
