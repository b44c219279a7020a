"""The port's Python presets (sheeprl_tpu_torch/configs.py) against the JAX
package's composed YAML tree: for every size XS to XL, every key the port
reads has the same value, so the two configs cannot drift apart."""

import pytest

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu_torch.configs import SIZES, compose

# every key the port reads (agent.build_agent, envs.factory, utils.test,
# the replay placement and the train window of dreamer_v3.main)
PORT_KEYS = [
    "seed",
    "dry_run",
    "distribution.type",
    "env.id",
    "env.num_envs",
    "env.frame_stack",
    "env.screen_size",
    "env.grayscale",
    "env.max_episode_steps",
    "algo.cnn_keys.encoder",
    "algo.mlp_keys.encoder",
    "algo.unimix",
    "algo.world_model.stochastic_size",
    "algo.world_model.discrete_size",
    "algo.world_model.learnable_initial_recurrent_state",
    "algo.world_model.encoder.cnn_channels_multiplier",
    "algo.world_model.encoder.mlp_layers",
    "algo.world_model.encoder.dense_units",
    "algo.world_model.recurrent_model.recurrent_state_size",
    "algo.world_model.recurrent_model.dense_units",
    "algo.world_model.recurrent_model.fused",
    "algo.world_model.transition_model.hidden_size",
    "algo.world_model.representation_model.hidden_size",
    "algo.actor.cls",
    "algo.actor.init_std",
    "algo.actor.min_std",
    "algo.actor.max_std",
    "algo.actor.dense_units",
    "algo.actor.mlp_layers",
    "algo.actor.action_clip",
    # the replay and train-window keys (data/device_buffer.py, ops/superstep.py)
    "buffer.memmap",
    "buffer.validate_args",
    "buffer.prefetch",
    "buffer.device",
    "buffer.device_max_bytes",
    "algo.fused_gradient_steps",
]


def _get(tree, dotted):
    for p in dotted.split("."):
        tree = tree[p]
    return tree


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("env", ["pixel_catcher", "dummy_discrete"])
def test_presets_equal_the_composed_jax_config(size, env):
    jax_env = "dummy" if env.startswith("dummy") else env
    overrides = ["exp=dreamer_v3", f"algo=dreamer_v3_{size}", f"env={jax_env}"]
    if env.startswith("dummy"):
        overrides.append(f"env.id={env}")
    want = jax_compose("config", overrides)
    got = compose(size, env=env)
    for key in PORT_KEYS + ["fabric.precision"]:
        assert _get(got, key) == _get(want, key), key


def test_overrides_reach_the_derived_keys():
    """A dotted override feeds every ${...} reference to it, as in the JAX
    composer."""
    cfg = compose("S", overrides={"algo.dense_units": 64, "algo.unimix": 0.0})
    assert cfg["algo"]["world_model"]["recurrent_model"]["dense_units"] == 64
    assert cfg["algo"]["actor"]["dense_units"] == 64
    assert cfg["algo"]["actor"]["unimix"] == 0.0
    want = jax_compose("config", ["exp=dreamer_v3", "algo.dense_units=64"])
    assert want["algo"]["actor"]["dense_units"] == 64


@pytest.mark.parametrize("bad", [{"size": "XXL"}, {"env": "atari"}, {"overrides": {"algo.nope": 1}}])
def test_compose_rejects_unknown_names(bad):
    with pytest.raises((ValueError, KeyError)):
        compose(**bad)
