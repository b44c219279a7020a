"""PPO's overlapped collection (``algo.overlap_collection``, the JAX
``ppo.py:693-865``) and the two-slot ``RolloutStore`` on the CPU, at the
tiny CartPole widths of ``tests/test_torch_ppo.py``.

On the CPU the update runs eagerly where the card replays it on a stream
of its own, so these tests hold the schedule, not the concurrency: which
params collected each rollout (with overlap, rollout N the params from
after update N-2), the rollback of a non-finite in-flight update together
with the rollout collected against it, the drain before the final
checkpoint and the test, and each update equal bit for bit to the same
update run alone. The card's side stream is held in
``tests/test_torch_cuda.py``.
"""

import glob
import os

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.ppo import ppo as tppo
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.convert import agent_from_flax
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops.optim import build_optimizer
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.prealloc import RolloutStore
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_ppo import PPO


def _cfg(tmp_path, name, *extra):
    return dotdict(compose("config", PPO + [f"log_base_dir={tmp_path}", f"run_name={name}", "algo.total_steps=128", *extra]))


def test_rollout_store_rotates_its_slots():
    store = RolloutStore(4, slots=2)
    a, b = store.begin(1), store.begin(2)
    assert a is not b and store.begin(3) is a and store.begin(4) is b
    one = RolloutStore(4)
    assert one.begin(1) is one.begin(2)
    with pytest.raises(ValueError, match="slots"):
        RolloutStore(4, slots=0)


@pytest.mark.parametrize("overlap", [False, True])
def test_schedule_of_the_params_that_collect_each_rollout(tmp_path, overlap):
    """Without overlap rollout N is collected with the params after update
    N-1; with it, after update N-2 (the first two with the initial ones).
    The waits are timed, and every update is finalised by the end."""
    out = tppo.main(_cfg(tmp_path, "s", f"algo.overlap_collection={overlap}"), device="cpu")
    lag = 2 if overlap else 1
    assert out["overlap_collection"] is overlap and out["updates"] == 4
    assert out["collected_with"] == [(n, max(0, n - lag)) for n in range(1, 5)]
    assert (out["train_wait_seconds"] > 0) is overlap


def test_a_non_finite_in_flight_update_rolls_back_with_its_rollout(tmp_path):
    """A NaN forced at update 3 is seen when update 4's rollout is in: the
    params and optimizer go back to update 2's checkpoint, rollout 4 is
    dropped with update 3, and rollout 5 is collected with update 2's
    params."""
    cfg = _cfg(tmp_path, "nan", "algo.overlap_collection=True", "algo.total_steps=160", "checkpoint.every=64")
    cfg.resilience.fault_injection = {"enabled": True, "faults": [{"kind": "nan", "at_update": 3}]}
    out = tppo.main(cfg, device="cpu")
    assert out["rollbacks"] == 1
    assert out["collected_with"] == [(1, 0), (2, 0), (3, 1), (4, 2), (5, 2)]
    # updates 1, 2, 3 (rolled back) and 5 ran; 4 was never dispatched
    assert out["updates"] == 4 and all(np.isfinite(v) for v in out["metrics"].values())


def test_the_last_update_is_drained_before_the_checkpoint_and_the_test(tmp_path, monkeypatch):
    """The final checkpoint and the test's player hold the params after the
    last update, not one update stale."""
    seen = {}
    real_test = tppo.test

    def test(player, *a, **kw):
        seen.update({k: v.clone() for k, v in player.agent.state_dict().items()})
        return real_test(player, *a, **kw)

    monkeypatch.setattr(tppo, "test", test)
    out = tppo.main(_cfg(tmp_path, "drain", "algo.overlap_collection=True"), device="cpu")
    (ckpt,) = sorted(glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt")))[-1:]
    final = load_checkpoint(ckpt)
    assert final["update"] == 4
    for k, v in agent_from_flax(final["agent"]).items():
        torch.testing.assert_close(seen[k], v, rtol=0, atol=0)


def test_each_overlapped_update_equals_the_update_run_alone(tmp_path):
    """Every update of an overlapped run, replayed alone from its recorded
    inputs, params, optimizer state and train stream: the metrics and the
    new state agree bit for bit (overlap changes only which params
    collected the rollouts)."""
    cfg = _cfg(tmp_path, "rec", "algo.overlap_collection=True")
    record = []
    tppo.main(cfg, device="cpu", record=record)
    assert [r["update"] for r in record] == [1, 2, 3, 4]
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    agent, _ = build_agent((2,), False, cfg, space, device="cpu")
    opt = build_optimizer(list(agent.parameters()), cfg.algo.optimizer, float(cfg.algo.max_grad_norm))
    gen = torch.Generator()
    n_local = int(cfg.algo.rollout_steps) * int(cfg.env.num_envs)
    update = tppo.make_update_fn(agent, tppo.make_local_train(agent, opt, cfg, ["state"], n_local, gen), cfg, ["state"])
    for r in record:
        with torch.no_grad():
            for t, s in zip(tppo.opt_state_tensors(agent, opt), r["state_before"]):
                t.copy_(s)
        gen.set_state(r["generator"])
        metrics = update(r["inputs"])
        torch.testing.assert_close(metrics, r["metrics"], rtol=0, atol=0)
        for t, s in zip(tppo.opt_state_tensors(agent, opt), r["state_after"]):
            torch.testing.assert_close(t.detach(), s, rtol=0, atol=0)


def test_the_fused_rollout_turns_overlap_off(tmp_path):
    out = tppo.main(_cfg(tmp_path, "f", "algo.overlap_collection=True", "algo.fused_rollout=True"), device="cpu")
    assert out["fused_rollout"] and not out["overlap_collection"] and out["collected_with"] == []
