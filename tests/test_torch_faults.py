"""Config keys the port once dropped or refused, each held to what the JAX
package does with it: ``buffer.validate_args`` in the Dreamer-V3 loop (its
``EnvLoop`` also runs both P2E-DV3 phases; JAX ``dreamer_v3.py:861,926``),
the run record's loop ``variant`` (JAX ``cli.py:248-261``) and the config
tree's ``fabric.accelerator: tpu``."""

import json

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import EnvLoop
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.envs import spaces
from tests.test_torch_ppo import PPO


class _TwoEnvs:
    """Two envs of a 3-float state; env 0's episode ends at its second step."""

    single_action_space = spaces.Discrete(2)

    def __init__(self):
        self.t = 0

    def reset(self, seed=None):
        return {"state": np.zeros((2, 3), np.float32)}, {}

    def step(self, actions):
        self.t += 1
        obs = {"state": np.full((2, 3), self.t, np.float32)}
        terminated = np.array([self.t == 2, False])
        infos = {}
        if terminated.any():
            infos["final_obs"] = np.array([{"state": np.full(3, -1.0, np.float32)}, None], dtype=object)
        return obs, np.ones(2, np.float32), terminated, np.zeros(2, bool), infos


class _Player:
    def init_states(self, idx=None):
        pass


@pytest.mark.parametrize("validate", [False, True])
def test_the_dreamer_v3_loop_passes_buffer_validate_args_to_both_adds(validate, monkeypatch):
    calls = []
    add = EnvIndependentReplayBuffer.add

    def recording_add(self, data, indices=None, validate_args=False):
        calls.append((indices, validate_args))
        return add(self, data, indices, validate_args)

    monkeypatch.setattr(EnvIndependentReplayBuffer, "add", recording_add)
    cfg = {
        "env": {"num_envs": 2},
        "algo": {"cnn_keys": {"encoder": []}, "mlp_keys": {"encoder": ["state"]}},
        "metric": {"log_level": 0},
        "buffer": {"validate_args": validate},
    }
    rb = EnvIndependentReplayBuffer(8, n_envs=2)
    loop = EnvLoop(_TwoEnvs(), rb, _Player(), cfg, None, None, np.random.default_rng(0))
    loop.reset(seed=0)
    loop.step(random=True)
    loop.step(random=True)
    assert calls == [(None, validate), (None, validate), ([0], validate)]
    assert rb.buffer[0]["state"][2, 0].tolist() == [-1.0, -1.0, -1.0]


@pytest.mark.parametrize(
    "overrides, variant",
    [([], None), (["algo.fused_rollout=True"], "fused_rollout"), (["algo.overlap_collection=True"], "overlap_collection")],
)
def test_the_run_record_names_the_loop_variant(overrides, variant, tmp_path):
    runs = tmp_path / "RUNS.jsonl"
    argv = PPO + ["algo.total_steps=32", f"metric.telemetry.runs_jsonl={runs}", f"log_base_dir={tmp_path}", "run_name=v"]
    cli.run(argv + overrides)
    (record,) = [json.loads(line) for line in runs.read_text().splitlines()]
    assert (record["kind"], record["outcome"], record.get("variant")) == ("train", "completed", variant)


def test_the_trees_tpu_accelerator_names_the_card(monkeypatch):
    """``exp=dreamer_v3_dmc_walker_walk`` (and ``fabric=tpu``) set
    ``fabric.accelerator: tpu``, the JAX tree's name for its accelerator:
    the port reads it as the card, and without one raises as for
    ``cuda``."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import accelerator_device

    assert compose("config", ["exp=dreamer_v3_dmc_walker_walk"])["fabric"]["accelerator"] == "tpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("tpu", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            accelerator_device(name)
    assert accelerator_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported accelerator"):
        accelerator_device("xla")
