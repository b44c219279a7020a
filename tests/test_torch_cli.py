"""The port's entry points: the registry's contract and errors against the
JAX registry's, ``python -m sheeprl_tpu_torch`` and ``cli_eval`` end to end on
the CPU (``fabric=cpu``) in a child process with JAX, PyYAML, gymnasium and
tensorboard blocked, the refusals (no CPU fallback, devices, serve's
torn checkpoints and unported options), and
``resume_from_checkpoint`` on a JAX run's ``yaml.safe_dump`` config."""

import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.utils import registry as jax_registry
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.parallel.fabric import Fabric, fabric_from_config
from sheeprl_tpu_torch.serve.errors import SwapRejected
from sheeprl_tpu_torch.utils import registry
from sheeprl_tpu_torch.utils.callback import CheckpointCallback
from sheeprl_tpu_torch.utils.logger import read_scalars
from sheeprl_tpu_torch.utils.utils import dotdict

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ["jax", "jaxlib", "flax", "optax", "gymnasium", "yaml", "tensorboard", "sheeprl_tpu"]
# __graft_entry__.py::_tiny_dv3_cfg with the sequence length 1 a dry run samples
TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.id=dummy_discrete",
    "fabric=cpu",
    "dry_run=True",
    "env.capture_video=False",
    "buffer.memmap=False",
    "algo.per_rank_batch_size=1",
    "algo.per_rank_sequence_length=1",
    "buffer.size=8",
    "algo.learning_starts=0",
    "algo.horizon=4",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "env.num_envs=2",
    "env.screen_size=16",
]


def _run_blocked(module, argv, cwd, runs, blocked=BLOCKED):
    code = (
        "import runpy, sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = [{module!r}] + {list(argv)!r}\n"
        f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), SHEEPRL_TPU_RUNS_JSONL=str(runs))
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def test_cli_trains_and_evaluates_on_the_cpu_with_jax_and_friends_blocked(tmp_path):
    runs = tmp_path / "RUNS.jsonl"
    _run_blocked("sheeprl_tpu_torch", TINY + ["metric.telemetry.enabled=True", "run_name=tiny"], tmp_path, runs)
    base = tmp_path / "logs" / "runs" / "dreamer_v3" / "dummy_discrete" / "tiny"
    version = base / "version_0"
    stored = json.loads((version / "config.yaml").read_text())
    assert stored["fabric"]["accelerator"] == "cpu" and stored["algo"]["dense_units"] == 8
    (ckpt,) = glob.glob(str(version / "checkpoint" / "*.ckpt"))
    (events,) = glob.glob(str(version / "events.out.tfevents.*"))
    tags = {tag for _, tag, _ in read_scalars(events)}
    assert {"Loss/world_model_loss", "Time/sps_train", "Time/sps_env_interaction"} <= tags
    stream = [json.loads(line) for line in (base / "telemetry.jsonl").read_text().splitlines()]
    beats = [e for e in stream if e["event"] == "heartbeat"]
    assert len(beats) == 1 and beats[0]["device_kind"] == "cpu" and beats[0]["flops_per_train_step"] > 0
    assert stream[-1]["event"] == "run_end" and stream[-1]["ckpt_commits"] == 1
    (record,) = [json.loads(line) for line in runs.read_text().splitlines()]
    assert (record["kind"], record["outcome"], record["algo"]) == ("train", "completed", "dreamer_v3")
    assert record["train_gradient_steps"] == 1 and record["telemetry_jsonl"].endswith("telemetry.jsonl")
    # cli_eval on that checkpoint: one episode, an eval record
    out = _run_blocked("sheeprl_tpu_torch.cli_eval", [f"checkpoint_path={ckpt}"], tmp_path, runs)
    assert "Test - Reward:" in out
    records = [json.loads(line) for line in runs.read_text().splitlines()]
    assert [(r["kind"], r["outcome"]) for r in records] == [("train", "completed"), ("eval", "completed")]
    assert records[-1]["checkpoint"] == ckpt


def test_without_a_card_the_default_accelerator_raises(tmp_path):
    """``fabric.accelerator=auto`` (the default) means the CUDA card: no
    CPU fallback. So does ``tpu``, the config tree's name for its
    accelerator (``exp=dreamer_v3_dmc_walker_walk``)."""
    argv = [a for a in TINY if a != "fabric=cpu"] + [f"log_base_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.run(argv)
    for accelerator in ("auto", "gpu", "cuda", "tpu"):
        with pytest.raises(RuntimeError, match="CUDA card"):
            Fabric(accelerator=accelerator)
    with pytest.raises(ValueError, match="accelerator"):
        Fabric(accelerator="xla")


@pytest.mark.parametrize(
    "kwargs", [{"devices": 2}, {"num_nodes": 2}, {"mesh_axes": ["data", "model"]}, {"aot_cache_dir": "x"}]
)
def test_fabric_refuses_what_one_device_cannot_do(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Fabric(accelerator="cpu", **kwargs)


def test_the_fabric_node_builds_the_ports_fabric():
    cfg = compose("config", ["exp=dreamer_v3", "env=pixel_catcher", "fabric=cpu", "run_name=x"])
    fabric = fabric_from_config(cfg.fabric)
    assert fabric.device.type == "cpu" and fabric.precision.name == "fp32"
    (callback,) = fabric.callbacks
    assert isinstance(callback, CheckpointCallback) and callback.keep_last == 5 and callback.async_save


def test_serve_is_not_ported(tmp_path):
    """(Named when ``serve`` was refused.) ``serve`` now dispatches to
    ``cli_serve``, which refuses a checkpoint without a commit manifest."""
    torn = tmp_path / "checkpoint" / "ckpt_9_0.ckpt"
    torn.parent.mkdir()
    torn.write_bytes(b"half a checkpoint")
    with pytest.raises(SwapRejected, match="manifest"):
        cli.run(["serve", f"checkpoint_path={torn}"])


@pytest.mark.parametrize(
    "override, item",
    [
        ("serve.fleet.enabled=True", "A7.1"),
        ("serve.aot_cache_dir=/tmp/aot", "A10"),
        ("serve.fleet.remote_agents=[localhost:1]", "A10"),
    ],
)
def test_serve_refuses_what_is_not_ported(tmp_path, capsys, override, item):
    """Each serve key by its ROADMAP item: the replica fleet (A7.1, ported)
    composes and serves a short load run, its record ``variant: fleet``;
    remote agents and the executable cache (A10) raise, naming the item."""
    from sheeprl_tpu_torch.obs.registry import read_run_records
    from sheeprl_tpu_torch.resilience.manifest import build_manifest
    from sheeprl_tpu_torch.serve.policy import make_linear_state
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

    runs = tmp_path / "RUNS.jsonl"
    (tmp_path / "config.yaml").write_text(json.dumps({"algo": {"name": "linear"}, "seed": 1, "metric": {"telemetry": {"runs_jsonl": str(runs)}}}))
    state = make_linear_state()
    ckpt = tmp_path / "checkpoint" / "ckpt_5_0.ckpt"
    save_checkpoint(str(ckpt), state, manifest=build_manifest(step=5, backend="pickle", world_size=1, state=state))
    argv = ["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", override]
    if item == "A10":
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            cli.run(argv)
        return
    cli.run([*argv, "serve.load.enabled=true", "serve.load.duration_s=0.2", "serve.load.concurrency=2"])
    out = capsys.readouterr().out
    assert "fleet replicas=4" in out
    snap = json.loads(out[out.index('{\n  "serve_stats"') :])["serve_stats"]
    assert snap["load_report"]["ok"] > 0 and snap["load_report"]["errors"] == 0
    assert snap["fleet"]["active_device_replicas"] == 4 and snap["fleet"]["router"]["routed"] >= snap["load_report"]["ok"]
    (record,) = read_run_records(str(runs))
    assert (record["kind"], record["variant"], record["outcome"]) == ("serve", "fleet", "completed")


def test_profiler_is_refused(tmp_path):
    """``metric.profiler`` no longer raises: it wraps the run in the
    whole-run trace, which owns the process's one profiler session, so a
    triggered window inside the same run is refused (its start fails and is
    counted in the run record) and the run completes."""
    runs = tmp_path / "RUNS.jsonl"
    argv = TINY + ["dry_run=False", "algo.total_steps=8", "metric.profiler.enabled=True", "metric.telemetry.enabled=True"]
    cli.run(argv + ["metric.telemetry.profile_windows=[2]", f"metric.telemetry.runs_jsonl={runs}", f"log_base_dir={tmp_path}", "run_name=p"])
    (trace,) = glob.glob(f"{tmp_path}/dreamer_v3/dummy_discrete/p/profile/trace.json")
    assert os.path.getsize(trace) > 0
    (record,) = [json.loads(line) for line in runs.read_text().splitlines()]
    assert record["outcome"] == "completed" and "profile_captures" not in record
    assert record["profile_failed_starts"] == 1 and "already open" in record["profile_last_error"]


# exp=dreamer_v3 as composed (env=gym: CartPole-v1 frames at 64x64) at TINY's
# widths, 4 windows of 2 envs, the second traced
PIXELS = [a for a in TINY if a.startswith(("algo.", "fabric", "buffer")) and not a.startswith(("algo.cnn_keys", "algo.mlp_keys"))]
PIXELS += ["exp=dreamer_v3", "env.capture_video=False", "env.num_envs=2", "env.backend=sync", "algo.total_steps=8"]
DRAWING = ["pygame", "cv2", "rich", "mlflow"]


def test_dreamer_v3_trains_on_cartpole_frames_without_pygame(tmp_path):
    """The flagship's default config on the port's own CartPole-v1 frames,
    with JAX, gymnasium, pygame, cv2 and rich blocked: a triggered window
    traced, then ``cli_registration`` of the run's checkpoint and
    ``cli_agents``."""
    runs = tmp_path / "RUNS.jsonl"
    blocked = BLOCKED + DRAWING
    argv = PIXELS + ["metric.telemetry.enabled=True", "metric.telemetry.profile_windows=[2]", "run_name=px"]
    _run_blocked("sheeprl_tpu_torch", argv, tmp_path, runs, blocked)
    version = tmp_path / "logs" / "runs" / "dreamer_v3" / "CartPole-v1" / "px" / "version_0"
    stored = json.loads((version / "config.yaml").read_text())
    assert stored["env"]["id"] == "CartPole-v1" and stored["algo"]["cnn_keys"]["encoder"] == ["rgb"]
    (record,) = [json.loads(line) for line in runs.read_text().splitlines()]
    (capture,) = record["profile_captures"]
    assert capture["windows"] == [2] and capture["trace_dir"].endswith("window_00002")
    assert os.path.getsize(os.path.join(tmp_path, capture["trace_dir"], "trace.json")) > 0
    (ckpt,) = glob.glob(str(version / "checkpoint" / "*.ckpt"))
    _run_blocked("sheeprl_tpu_torch.cli_registration", [f"checkpoint_path={ckpt}", "model_manager.registry_dir=reg"], tmp_path, runs, blocked)
    index = json.loads((tmp_path / "reg" / "registry.json").read_text())
    assert sorted(index) == sorted(f"dreamer_v3_CartPole-v1_{m}" for m in ("world_model", "actor", "critic", "target_critic", "moments"))
    agents = _run_blocked("sheeprl_tpu_torch.cli_agents", [], tmp_path, runs, blocked).splitlines()
    assert len(agents) == 15


def test_cli_agents_prints_the_jax_packages_plain_listing(capsys, monkeypatch):
    """The JAX package's plain-text branch (``rich`` hidden), its package
    name mapped to the port's, less the algorithms the port refuses."""
    from sheeprl_tpu import cli as jax_cli

    for name in ("rich", "rich.console", "rich.table"):
        monkeypatch.setitem(sys.modules, name, None)
    jax_cli.available_agents()
    want = [
        line.replace("sheeprl_tpu.", "sheeprl_tpu_torch.", 1)
        for line in capsys.readouterr().out.splitlines()
        if line.split(": ", 1)[1].split(" ", 1)[0] not in cli.UNPORTED_ALGORITHMS
    ]
    cli.available_agents()
    got = capsys.readouterr().out.splitlines()
    assert len(got) == 15 and sorted(got) == sorted(want)


# the default exps that compose env=gym with pixel observations
PIXEL_EXPS = [
    "dreamer_v3",
    "dreamer_v2",
    "dreamer_v1",
    "p2e_dv3_exploration",
    "p2e_dv3_finetuning",
    "p2e_dv2_exploration",
    "p2e_dv2_finetuning",
    "p2e_dv1_exploration",
    "p2e_dv1_finetuning",
    "sac_ae",
]


@pytest.mark.parametrize("exp", PIXEL_EXPS)
def test_pixel_exps_build_their_vector_env(exp):
    """Each exp as composed builds its vector env (CartPole-v1 or
    Pendulum-v1 frames, 64x64, SAC-AE's stack of 3) and steps it."""
    import numpy as np

    from sheeprl_tpu_torch.envs.factory import build_vector_env
    from sheeprl_tpu_torch.utils.utils import dotdict

    extra = ["checkpoint.exploration_ckpt_path=unused.ckpt"] if "finetuning" in exp else []
    cfg = dotdict(compose("config", [f"exp={exp}", "env.capture_video=False", "env.backend=sync", "env.num_envs=2", *extra]))
    assert cfg.env.wrapper["_target_"] == "gymnasium.make" and cfg.algo.cnn_keys.encoder == ["rgb"]
    envs = build_vector_env(cfg, 0)
    obs, _ = envs.reset(seed=0)
    action = envs.single_action_space.sample()
    obs, *_ = envs.step(np.stack([action, action]))
    shape = (2, 3, 64, 64, 3) if exp == "sac_ae" else (2, 64, 64, 3)
    assert list(obs) == ["rgb"] and obs["rgb"].shape == shape and obs["rgb"].dtype == np.uint8
    assert 0 < obs["rgb"].mean() < 255  # a drawn frame, not a blank
    envs.close()


# the Dreamer-family names ported from ROADMAP A6.2 and A6.3
DREAMER_FAMILY = ("dreamer_v1", "p2e_dv1_exploration", "p2e_dv1_finetuning", "p2e_dv2_exploration", "p2e_dv2_finetuning")


@pytest.mark.parametrize("name", DREAMER_FAMILY)
def test_dreamer_family_names_are_registered(name):
    """Each of the last five Dreamer-family names has a training entry
    point in ``cli`` and an evaluation in ``cli_eval``, in the module the
    JAX registry names, and is no longer refused."""
    assert name not in cli.UNPORTED_ALGORITHMS
    cli.refuse_unported(name)
    cli._register_algorithms()
    pkg = "p2e_" + name.split("_")[1] if name.startswith("p2e") else name
    train, evaluate = registry.find_algorithm(name), registry.find_evaluation(name)
    assert (train["module"], train["entrypoint"], train["decoupled"]) == (f"sheeprl_tpu_torch.algos.{pkg}.{name}", "main", False)
    assert (evaluate["module"], evaluate["entrypoint"]) == (f"sheeprl_tpu_torch.algos.{pkg}.evaluate", "evaluate")


@pytest.mark.parametrize("name", ["ppo_decoupled", "sac_decoupled"])
def test_decoupled_names_are_refused_naming_a10(name, tmp_path):
    """The decoupled player/trainer entry points stay refused, with
    ``NotImplementedError`` naming ROADMAP A10, in ``cli`` and in
    ``cli_eval``; nothing else is."""
    assert set(cli.UNPORTED_ALGORITHMS) == {"ppo_decoupled", "sac_decoupled"}
    with pytest.raises(NotImplementedError, match=r"ROADMAP A10"):
        cli.run([f"exp={name}", "fabric=cpu", f"log_base_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match=r"ROADMAP A10"):
        cli.eval_algorithm(dotdict(compose("config", [f"exp={name}", "fabric=cpu"])))


def test_an_unregistered_algorithm_is_refused_with_the_registrys_error():
    cfg = dotdict(compose("config", TINY + ["algo.name=nope"]))
    with pytest.raises(ValueError, match="unknown algorithm 'nope'; registered algorithms: .*dreamer_v3"):
        cli.check_configs(cfg)
    with pytest.raises(ValueError, match="no registered evaluation for 'nope'"):
        cli.eval_algorithm(cfg)


@pytest.mark.parametrize("jax_run", [True, False])
def test_resume_takes_the_stored_config_and_the_fabric_overrides(tmp_path, jax_run):
    stored = jax_compose("config", ["exp=dreamer_v3", "env=pixel_catcher", "run_name=old", "seed=9"]).to_dict()
    ckpt_dir = tmp_path / "version_0" / "checkpoint"
    ckpt_dir.mkdir(parents=True)
    text = yaml.safe_dump(stored) if jax_run else json.dumps(stored)
    (tmp_path / "version_0" / "config.yaml").write_text(text)
    overrides = ["exp=dreamer_v3", "env=pixel_catcher", "fabric.precision=32-true", "run_name=new"]
    overrides.append(f"checkpoint.resume_from={ckpt_dir / 'ckpt_8_0.ckpt'}")
    cfg = dotdict(compose("config", overrides))
    merged = cli.resume_from_checkpoint(cfg, cli_overrides=overrides)
    assert merged.seed == 9 and merged.run_name == "new"
    assert merged.fabric.precision == "32-true" and merged.fabric.accelerator == stored["fabric"]["accelerator"]
    assert merged.checkpoint.resume_from == str(ckpt_dir / "ckpt_8_0.ckpt")
    other = dotdict(compose("config", ["exp=dreamer_v3", "env=dummy", "run_name=new", f"checkpoint.resume_from={ckpt_dir / 'c'}"]))
    with pytest.raises(ValueError, match="different environment"):
        cli.resume_from_checkpoint(other)


def test_registry_contract_matches_the_jax_registry(monkeypatch):
    cli._register_algorithms()
    assert registry.find_algorithm("dreamer_v3") == {
        "module": "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
        "name": "dreamer_v3",
        "entrypoint": "main",
        "decoupled": False,
    }
    assert registry.find_evaluation("dreamer_v3")["entrypoint"] == "evaluate"
    for reg in (registry, jax_registry):
        monkeypatch.setattr(reg, "algorithm_registry", {})
        monkeypatch.setattr(reg, "evaluation_registry", {})

        def main(fabric, cfg):
            pass

        main.__module__ = "pkg.algos.toy.toy"
        reg.register_algorithm()(main)
        assert reg.find_algorithm("toy")["entrypoint"] == "main"
        with pytest.raises(ValueError, match="already registered"):
            reg.register_algorithm()(main)
        with pytest.raises(ValueError, match="unknown algorithm"):
            reg.register_evaluation(algorithms="nope")(main)
        with pytest.raises(ValueError, match="unknown algorithm 'nope'"):
            reg.find_algorithm("nope")
        with pytest.raises(ValueError, match="no registered evaluation"):
            reg.find_evaluation("toy")
