"""The fused on-policy superstep (``ops/rollout_scan.py``) against the
port's own host-loop rollout (``algos/ppo/ppo.py::collect_rollout`` and
``make_update_fn``), and the scenario variants (``envs/variants.py``)
against the JAX package's.

The superstep runs eagerly on the CPU. The host loop steps the same twin
through a vector env of the gym API (SAME_STEP autoreset, the terminal
observation in ``info["final_obs"]``) that draws its resets as the
superstep does, from the same env generator state and carry, with the
policy drawing from the same generator state: every rollout tensor, the
returns and advantages, and the parameters after the update within
``ROLLOUT_TOL``. One env starts five steps short of its step limit, so the
truncation bootstrap runs.

The variants: the same ``theta`` rows and the same uniform and normal
draws (the JAX draws, injected through ``variants._uniform_noise`` and
``_normal_noise``) give the same states, observations and rewards within
``VARIANT_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs import jittable as jjit
from sheeprl_tpu.envs import variants as jvar
from sheeprl_tpu_torch.algos.ppo import agent as tagent
from sheeprl_tpu_torch.algos.ppo import ppo as tppo
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs import variants as tvar
from sheeprl_tpu_torch.envs.jittable import get_jittable_env
from sheeprl_tpu_torch.ops.optim import adam
from sheeprl_tpu_torch.ops.rollout_scan import _select, flatten_state, init_env_carry, make_onpolicy_superstep_fn, unflatten_state
from sheeprl_tpu_torch.utils.prealloc import RolloutStore
from tests.test_torch_ppo import _cfg

ROLLOUT_TOL = 1e-6
VARIANT_TOL = 1e-6
T, E = 16, 4


class TwinVectorEnv:
    """A vector env of the gym API over a batched twin, for the host loop:
    SAME_STEP autoreset with reset states drawn for every env every step
    from ``generator``, as the superstep draws them."""

    def __init__(self, spec, carry, generator, n_actions):
        self.spec, self.generator = spec, generator
        self.state = unflatten_state({k: v.clone() for k, v in carry.items()})
        self.num_envs = E
        self.single_action_space = spaces.Box(-2, 2, (1,), np.float32) if spec.is_continuous else spaces.Discrete(n_actions)
        self.ep_ret = torch.zeros(E)
        self.ep_len = torch.zeros(E, dtype=torch.int32)

    def obs(self):
        return {"state": self.spec.observation(self.state).numpy()}

    def step(self, actions):
        act = torch.as_tensor(np.asarray(actions))
        nxt, out = self.spec.step(self.state, act, self.generator)
        done = out.terminated | out.truncated
        self.ep_ret += out.reward
        self.ep_len += 1
        info = {}
        if bool(done.any()):
            info["final_obs"] = [{"state": out.obs[i].numpy()} for i in range(E)]
            info["final_info"] = {
                "episode": {"r": self.ep_ret.numpy().copy(), "l": self.ep_len.numpy().copy(), "_r": done.numpy()}
            }
        self.state = _select(done, self.spec.init(self.generator, E), nxt)
        self.ep_ret = torch.where(done, 0.0, self.ep_ret)
        self.ep_len = torch.where(done, 0, self.ep_len)
        return self.obs(), out.reward.numpy(), out.terminated.numpy(), out.truncated.numpy(), info


def _family_or_spec(kind):
    if kind == "CartPole-v1":
        return get_jittable_env(kind), None
    family = tvar.make_scenario_family("CartPole-v1", ["phys_mass", "sticky_actions", "reward_delay", "distractors"])
    thetas = torch.tensor(np.random.default_rng(0).uniform(0, 0.6, (E, family.param_dim)), dtype=torch.float32)
    return family, thetas


@pytest.mark.parametrize("kind", ["CartPole-v1", "CartPole-v1+variants"])
def test_fused_superstep_matches_the_host_loop(kind):
    spec, thetas = _family_or_spec(kind)
    cfg = _cfg(update_epochs=2, per_rank_batch_size=16, gamma=0.99, gae_lambda=0.95)
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (spec.obs_dim,), np.float32)})
    agents = [tagent.build_agent((2,), False, cfg, space, device="cpu")[0] for _ in range(2)]
    opts = [adam(list(a.parameters()), cfg["algo"]["optimizer"], 0.5) for a in agents]
    gens = {k: [torch.Generator().manual_seed(s) for _ in range(2)] for k, s in (("policy", 1), ("env", 2), ("train", 3))}
    carry = init_env_carry(spec, E, gens["env"][0], thetas)
    gens["env"][1].set_state(gens["env"][0].get_state())
    (step_count,) = [k for k in carry if k.endswith("/t")]
    carry[step_count][0] = 495  # truncates at step 5
    coefs = torch.tensor([0.2, 0.01])
    seen = {}

    def recording(train):
        def local_train(flat, c):
            seen.update({k: v.clone() for k, v in flat.items()})
            return train(flat, c)

        return local_train

    trains = [tppo.make_local_train(a, o, cfg, ["state"], T * E, g) for a, o, g in zip(agents, opts, gens["train"])]
    env0 = spec.instantiate(carry["theta"]) if thetas is not None else spec
    host_env = TwinVectorEnv(env0, carry, gens["env"][1], 2)
    superstep = make_onpolicy_superstep_fn(
        spec,
        policy_fn=lambda obs, g: tagent.rollout_step(agents[0], obs, g),
        value_fn=lambda obs: agents[0](obs)[1],
        local_train=recording(trains[0]),
        obs_key="state",
        rollout_steps=T,
        gamma=0.99,
        gae_lambda=0.95,
        policy_generator=gens["policy"][0],
        env_generator=gens["env"][0],
    )
    f_metrics, ep_stats = superstep(carry, coefs)
    fused = dict(seen)

    player = tagent.PPOPlayer(agents[1], torch.device("cpu"))
    buf = RolloutStore(T).begin(1)
    next_obs = tppo.collect_rollout(player, host_env, buf, host_env.obs(), gens["policy"][1], T, 0.99, [])
    inputs = dict(buf.arrays())
    inputs["next/state"] = torch.from_numpy(next_obs["state"])
    inputs["coefs"] = coefs
    h_metrics = tppo.make_update_fn(agents[1], recording(trains[1]), cfg, ["state"])(inputs)

    assert bool(ep_stats["done"][4, 0]) and bool(fused["dones"].view(T, E)[4, 0])
    for k, v in fused.items():
        np.testing.assert_allclose(seen[k].numpy(), v.numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL, err_msg=k)
    np.testing.assert_allclose(h_metrics.numpy(), f_metrics.numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL)
    for p, q in zip(agents[0].parameters(), agents[1].parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL)
    # the carry moved on in place, to the host env's state
    for k, v in flatten_state(host_env.state).items():
        np.testing.assert_allclose(carry[k].numpy(), v.numpy(), atol=ROLLOUT_TOL)
    np.testing.assert_allclose(carry["ep_ret"].numpy(), host_env.ep_ret.numpy())


# --------------------------------------------------------------------------- #
# the variants against the JAX package
# --------------------------------------------------------------------------- #

NAMES = ["phys_size", "phys_speed", "phys_mass", "sticky_actions", "reward_delay", "distractors"]


def _jax_draws(key, n_steps, names, dims=4):
    """The uniforms and normals a JAX family step draws from ``key``, in
    the order the port's wrappers draw them (outermost first)."""
    order = [n for n in reversed(jvar.canonical_variant_order(names))]
    uniforms, normals = [], []
    for _ in range(n_steps):
        k = key
        for name in order:
            if name == "distractors":
                k_dx, k = jax.random.split(k)
                normals.append(np.asarray(jax.random.normal(k_dx, (dims,), jnp.float32)))
            elif name == "sticky_actions":
                k_sticky, k = jax.random.split(k)
                uniforms.append(np.asarray(jax.random.uniform(k_sticky)))
    return uniforms, normals


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_variants_match_jax_with_the_same_draws(env_id, monkeypatch):
    """Three envs with their own theta rows step 40 steps through every
    variant at once; both packages get the same draws."""
    jfam = jvar.make_scenario_family(env_id, NAMES)
    tfam = tvar.make_scenario_family(env_id, NAMES)
    assert (tfam.env_id, tfam.param_dim, tfam.obs_dim) == (jfam.env_id, jfam.param_dim, jfam.obs_dim)
    rng = np.random.default_rng(0)
    n = 3
    thetas = np.stack([rng.uniform(lo, hi, n) for lo, hi in (tvar.DEFAULT_RANGES[k] for k in tfam.variant_names)], 1)
    thetas[:, tfam.variant_names.index("sticky_actions")] = [0.0, 0.5, 0.9]
    thetas = thetas.astype(np.float32)
    keys = [jax.random.PRNGKey(i) for i in range(n)]
    jstates = [jfam.instantiate(jnp.asarray(thetas[i])).init(keys[i]) for i in range(n)]
    # the port starts from the JAX states, with the JAX init's distractor draws
    init_dx = np.stack([np.asarray(s["dx"]) for s in jstates])
    tspec = tfam.instantiate(torch.from_numpy(thetas))
    draws = {"normal": [torch.from_numpy(init_dx)], "uniform": []}
    monkeypatch.setattr(tvar, "_uniform_noise", lambda g, shape, dev: draws["uniform"].pop(0))
    monkeypatch.setattr(tvar, "_normal_noise", lambda g, shape, dev: draws["normal"].pop(0))
    tstate = tspec.init(torch.Generator(), n)
    leaves = jax.tree_util.tree_leaves_with_path(jstates[0])
    for path, _ in leaves:
        want = np.stack([np.asarray(jax.tree_util.tree_flatten_with_path(s)[0][[p for p, _ in leaves].index(path)][1]) for s in jstates])
        node = tstate
        for p in path:
            node = node[p.key]
        node.copy_(torch.as_tensor(want).reshape(node.shape).to(node.dtype))
    spec = jjit.get_jittable_env(env_id)
    for step in range(40):
        step_keys = [jax.random.fold_in(k, step) for k in keys]
        if spec.is_continuous:
            act = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
        else:
            act = rng.integers(0, 2, n).astype(np.int32)
        outs = []
        for i in range(n):
            jstates[i], out = jfam.instantiate(jnp.asarray(thetas[i])).step(jstates[i], jnp.asarray(act[i]), step_keys[i])
            outs.append(out)
        per_env = [_jax_draws(k, 1, NAMES) for k in step_keys]
        draws["uniform"] = [torch.tensor(np.stack([u[0][0] for u in per_env]))]
        draws["normal"] = [torch.from_numpy(np.stack([u[1][0] for u in per_env]))]
        tstate, tout = tspec.step(tstate, torch.from_numpy(act), None)
        np.testing.assert_allclose(tout.obs.numpy(), np.stack([np.asarray(o.obs) for o in outs]), atol=VARIANT_TOL, rtol=VARIANT_TOL)
        np.testing.assert_allclose(tout.reward.numpy(), np.stack([np.asarray(o.reward) for o in outs]), atol=VARIANT_TOL, rtol=VARIANT_TOL)
        np.testing.assert_array_equal(tout.terminated.numpy(), np.stack([np.asarray(o.terminated) for o in outs]))
        np.testing.assert_array_equal(tout.truncated.numpy(), np.stack([np.asarray(o.truncated) for o in outs]))
        done = np.logical_or(tout.terminated.numpy(), tout.truncated.numpy())
        if done.any():
            break
    assert step >= 5


def test_family_metadata_and_theta_matrix():
    fam = tvar.make_scenario_family("CartPole-v1", ["distractors", "phys_size"])
    assert fam.variant_names == ("phys_size", "distractors") and fam.obs_dim == 8
    assert tvar.make_scenario_family("PixelCatcher", ["phys_size"]) is None
    with pytest.raises(ValueError, match="unknown variant"):
        tvar.canonical_variant_order(["nope"])
    assert tvar.parse_variant_env_id(fam.env_id) == ("CartPole-v1", ("phys_size", "distractors"))
    m = tvar.sample_scenario_matrix(torch.Generator().manual_seed(0), 64, fam.variant_names, {"phys_size": (0.1, 0.2)})
    assert m.shape == (64, 2) and float(m[:, 0].min()) >= 0.1 and float(m[:, 0].max()) <= 0.2
    # theta = 0 is the identity of every variant
    ident = tvar.make_scenario_family("Pendulum-v1", NAMES[:-1]).instantiate(torch.zeros(2, 5))
    base = get_jittable_env("Pendulum-v1")
    s0 = base.init(torch.Generator().manual_seed(1), 2)
    s1 = ident.init(torch.Generator().manual_seed(1), 2)
    a = torch.tensor([[0.5], [-1.0]])
    _, o0 = base.step(s0, a)
    _, o1 = ident.step(s1, a, torch.Generator().manual_seed(2))
    assert torch.equal(o0.obs, o1.obs) and torch.equal(o0.reward, o1.reward)
