"""Fused supersteps (sheeprl_tpu_torch/ops/superstep.py and
``dreamer_v3.make_fused_train_fn``) on the CPU at tiny widths: the in-graph
target refresh against the JAX ``periodic_target_ema``, K steps in one call
against K sequential train steps with the host EMA between them, bit for
bit, and ``main()`` with the device ring, supersteps, a checkpoint holding
the ring and resumes across the buffer modes."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import superstep as jss
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer
from sheeprl_tpu_torch.ops.math import init_moments
from sheeprl_tpu_torch.ops.superstep import SAMPLE_KEY_SALT, periodic_target_ema, pregathered
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_dv3_train import batch, obs_space, tiny_cfg


@pytest.mark.parametrize("freq, tau", [(1, 0.02), (3, 0.5), (2, 0.1)])
def test_periodic_target_ema_refreshes_on_the_jax_counters(freq, tau):
    rng = np.random.default_rng(freq)
    src = [rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    tgt = [rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    t_tgt, j_tgt = [torch.from_numpy(a.copy()) for a in tgt], [jnp.asarray(a) for a in tgt]
    for counter in range(8):
        # the source moves on between counters, as the critic trains
        src_now = [a + np.float32(0.25 * counter) for a in src]
        before = [t.clone() for t in t_tgt]
        periodic_target_ema(torch.tensor(counter), [torch.from_numpy(a) for a in src_now], t_tgt, freq, tau)
        j_tgt = jss.periodic_target_ema(jnp.int32(counter), [jnp.asarray(a) for a in src_now], j_tgt, freq, tau)
        refreshed = not all(torch.equal(a, b) for a, b in zip(before, t_tgt))
        assert refreshed == (counter % freq == 0), counter
        # the same blend; XLA's CPU backend may fuse it into a fused
        # multiply-add, one rounding fewer: one ulp apart at most
        for got, want in zip(t_tgt, j_tgt):
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)
    assert SAMPLE_KEY_SALT == jss.SAMPLE_KEY_SALT


CNN, MLP, ACTIONS = ("rgb",), ("state",), (3,)
FREQ = 2


def _models(cfg, states=None):
    space = obs_space(CNN, MLP)
    torch.manual_seed(0)
    states = states or {}
    wm, actor, _ = tagent.build_agent(ACTIONS, False, cfg, space, states.get("wm"), states.get("actor"), device="cpu")
    critic, target = tagent.build_critic(cfg, wm.latent_state_size, states.get("critic"), states.get("target"), "cpu")
    with torch.no_grad():  # a target apart from the critic, so the first hard copy shows
        for p in target.parameters():
            p.add_(0.5)
    opts = tdv3.build_optimizers(cfg, wm, actor, critic)
    step = tdv3.make_train_step(wm, actor, critic, target, *opts, cfg, False)
    return dict(wm=wm, actor=actor, critic=critic, target=target), opts, step


def _state(models, opts, moments):
    out = {f"{k}.{n}": v.detach().clone() for k, m in models.items() for n, v in m.state_dict().items()}
    for i, o in enumerate(opts):
        out.update({f"opt{i}.mu{j}": t.clone() for j, t in enumerate(o.mu)})
        out.update({f"opt{i}.nu{j}": t.clone() for j, t in enumerate(o.nu)})
        out[f"opt{i}.count"] = o.count.clone()
    out["moments"] = torch.stack([moments.low, moments.high]).clone()
    return out


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("chunks", [(3,), (2, 1)], ids=["one_call", "split_2_1"])
def test_superstep_equals_sequential_steps_and_host_ema(start, chunks):
    """K = 3 steps over pregathered batches, from gradient step ``start``
    (0: the hard copy comes first), in one call or as 2 + 1 with the
    counter and the generator carried, against three sequential steps with
    the host EMA on the loop's schedule: metrics, parameters, target,
    optimizer state and Moments bit for bit."""
    cfg = tiny_cfg(CNN, MLP, **{"algo.critic.per_rank_target_network_update_freq": FREQ})
    tau = float(cfg["algo"]["critic"]["tau"])
    batches = [{k: torch.from_numpy(v) for k, v in batch(CNN, MLP, ACTIONS, False, seed=s).items()} for s in range(3)]

    models, opts, step = _models(cfg)
    moments = init_moments("cpu")
    gen = torch.Generator().manual_seed(7)
    want = []
    for i, b in enumerate(batches):
        if (start + i) % FREQ == 0:
            tdv3.ema_(models["critic"], models["target"], 1.0 if start + i == 0 else tau)
        want.append(step(moments, b, gen)[1])
    want_state = _state(models, opts, moments)

    fmodels, fopts, fstep = _models(cfg)
    fmoments = init_moments("cpu")
    fgen = torch.Generator().manual_seed(7)
    got, done = [], 0
    for n in chunks:
        stack = {k: torch.zeros((n, *v.shape), dtype=v.dtype) for k, v in batches[0].items()}
        fn = tdv3.make_fused_train_fn(
            fstep, fmodels["wm"], fmodels["actor"], fmodels["critic"], fmodels["target"], fopts, fmoments, cfg,
            pregathered, n, stack, (fgen,),
        )
        for k, v in stack.items():
            v.copy_(torch.stack([b[k] for b in batches[done : done + n]]))
        fn.inputs["counter"].fill_(start + done)
        metrics, finite = fn()
        assert metrics.shape == (n, len(tdv3.METRIC_ORDER)) and finite.tolist() == [True] * n
        got += list(metrics)
        done += n
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got_state = _state(fmodels, fopts, fmoments)
    assert got_state.keys() == want_state.keys()
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
    assert torch.equal(fgen.get_state(), gen.get_state())


def test_superstep_flags_a_step_that_poisons_the_parameters():
    cfg = tiny_cfg(CNN, MLP)
    models, opts, step = _models(cfg)
    b = {k: torch.from_numpy(v) for k, v in batch(CNN, MLP, ACTIONS, False).items()}
    stack = {k: torch.stack([v, v]) for k, v in b.items()}

    calls = []

    def poisoned(moments, data, generator=None):
        """The step, and at its second call an Inf in the critic's weights
        after the update while its metrics are still finite."""
        out = step(moments, data, generator)
        calls.append(1)
        if len(calls) == 2:
            with torch.no_grad():
                next(models["critic"].parameters()).view(-1)[0] = float("inf")
            assert torch.isfinite(out[1]).all()
        return out

    fn = tdv3.make_fused_train_fn(
        poisoned, models["wm"], models["actor"], models["critic"], models["target"], opts, init_moments("cpu"), cfg,
        pregathered, 2, stack, (torch.Generator().manual_seed(0),),
    )
    _, finite = fn()
    assert finite.tolist() == [True, False]


def _main_cfg(tmp_path, **extra):
    return tiny_cfg(
        (),
        ("state",),
        env="dummy_discrete",
        **{
            "env.num_envs": 2,
            "buffer.size": 64,
            "algo.learning_starts": 8,
            "algo.total_steps": 24,
            "buffer.checkpoint": True,
            "checkpoint.every": 8,
            "log_base_dir": str(tmp_path),
            "run_name": "ring",
            **extra,
        },
    )


def test_main_with_the_ring_and_supersteps_resumes_across_buffer_modes(tmp_path):
    """``buffer.device=true`` with K = 2 trains (ring draws in the superstep),
    checkpoints the ring, resumes into the memmapped host buffer (K = 2,
    prefetched stacks) and back into the ring (K = 0, gathers into the
    step's inputs): counters continue, training resumes at once (the buffer
    came back), and each resumed buffer holds the saved one's contents."""
    first = tdv3.main(_main_cfg(tmp_path, **{"buffer.device": True, "algo.fused_gradient_steps": 2}), device="cpu")
    assert first["replay_buffer"] == "device" and first["gradient_steps"] == 1 + 2 * 8
    # G = 1 then 2 a window: one superstep of 1, then one of 2 each window
    assert [g["steps"] for g in first["graphs"]] == [1, 2]
    ckpt = os.path.join(first["log_dir"], "checkpoint", "ckpt_24_0.ckpt")
    saved = load_checkpoint(ckpt)
    assert isinstance(saved["rb"], DeviceReplayBuffer) and "sample_rng_key" in saved
    ring_arrays = saved["rb"].host_arrays()
    # the checkpoint's ring flags each env's last step truncated
    last = (saved["rb"]._pos - 1) % saved["rb"].buffer_size
    assert (ring_arrays["truncated"][np.arange(2), last] == 1).all()

    host_cfg = _main_cfg(
        tmp_path,
        **{"buffer.device": False, "algo.fused_gradient_steps": 2, "checkpoint.resume_from": ckpt, "algo.total_steps": 32},
    )
    second = tdv3.main(host_cfg, device="cpu")
    assert second["replay_buffer"] == "memmap" and second["start_update"] == 13 and second["env_steps"] == 32
    assert second["gradient_steps"] == 2 * 4 and [g["steps"] for g in second["graphs"]] == [2]
    ckpt2 = os.path.join(second["log_dir"], "checkpoint", "ckpt_32_0.ckpt")
    host = load_checkpoint(ckpt2)["rb"]
    assert isinstance(host, EnvIndependentReplayBuffer)
    # the host run kept the ring's steps and added 4 an env after them
    for env, sub in enumerate(host.buffer):
        old = np.arange(saved["rb"]._pos[env] - 8, saved["rb"]._pos[env] - 1) % 32
        np.testing.assert_array_equal(sub.buffer["state"][old, 0], ring_arrays["state"][env, old])

    ring_cfg = _main_cfg(tmp_path, **{"buffer.device": True, "checkpoint.resume_from": ckpt2, "algo.total_steps": 40})
    third = tdv3.main(ring_cfg, device="cpu")
    assert third["replay_buffer"] == "device" and third["start_update"] == 17 and third["gradient_steps"] == 2 * 4
    assert all(np.isfinite(v) for v in third["metrics"].values())


def test_main_rolls_back_a_non_finite_superstep_window(tmp_path):
    """A forced non-finite window on the fused path (the finite vectors of
    its supersteps, reduced once) rolls back to the newest committed
    checkpoint, the sample stream re-seeded with the train stream, and the
    run finishes."""
    fault = {"enabled": True, "faults": [{"kind": "nan", "at_update": 10}]}
    cfg = _main_cfg(
        tmp_path, **{"buffer.device": True, "algo.fused_gradient_steps": 2, "resilience.fault_injection": fault}
    )
    with pytest.warns(UserWarning, match="rolled back to .*ckpt_16_0.ckpt"):
        out = tdv3.main(cfg, device="cpu")
    assert out["rollbacks"] == 1 and out["env_steps"] == 24
    assert all(np.isfinite(v) for v in out["metrics"].values())
