"""The port stands alone: no module of sheeprl_tpu_torch/ and not
chip_smoke.py imports JAX, flax, optax, gymnasium, PyYAML, cv2 or sheeprl_tpu, and the
package imports and runs ``evaluate`` on the CPU with those blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "gymnasium", "yaml", "cv2", "sheeprl_tpu"}


def _port_files():
    files = sorted((REPO / "sheeprl_tpu_torch").rglob("*.py"))
    assert len(files) >= 15
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import(path):
    bad = [(root, line) for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# the modules of the PPO slice: each is scanned by test_no_forbidden_import
PPO_SLICE = (
    "algos/ppo/agent.py",
    "algos/ppo/convert.py",
    "algos/ppo/evaluate.py",
    "algos/ppo/loss.py",
    "algos/ppo/ppo.py",
    "algos/ppo/utils.py",
    "envs/classic.py",
    "envs/variants.py",
    "ops/rollout_scan.py",
    "utils/prealloc.py",
)


# the modules of the A2C and recurrent PPO slice
RECURRENT_SLICE = (
    "algos/a2c/a2c.py",
    "algos/a2c/agent.py",
    "algos/a2c/evaluate.py",
    "algos/a2c/loss.py",
    "algos/a2c/utils.py",
    "algos/ppo_recurrent/agent.py",
    "algos/ppo_recurrent/convert.py",
    "algos/ppo_recurrent/evaluate.py",
    "algos/ppo_recurrent/ppo_recurrent.py",
    "algos/ppo_recurrent/utils.py",
    "models/blocks.py",
    "ops/optim.py",
)


# the modules of the SAC-family slice
SAC_SLICE = (
    "algos/sac/agent.py",
    "algos/sac/convert.py",
    "algos/sac/evaluate.py",
    "algos/sac/loss.py",
    "algos/sac/sac.py",
    "algos/sac/utils.py",
    "algos/droq/agent.py",
    "algos/droq/droq.py",
    "algos/droq/evaluate.py",
    "algos/droq/utils.py",
    "algos/sac_ae/agent.py",
    "algos/sac_ae/evaluate.py",
    "algos/sac_ae/sac_ae.py",
    "algos/sac_ae/utils.py",
    "data/device_buffer.py",
    "utils/utils.py",
)


def test_the_scan_covers_the_ppo_slice():
    scanned = {p.relative_to(REPO / "sheeprl_tpu_torch").as_posix() for p in _port_files()[:-1]}
    assert set(PPO_SLICE) <= scanned


def test_the_scan_covers_the_a2c_and_recurrent_ppo_slice():
    scanned = {p.relative_to(REPO / "sheeprl_tpu_torch").as_posix() for p in _port_files()[:-1]}
    assert set(RECURRENT_SLICE) <= scanned


def test_the_scan_covers_the_sac_family_slice():
    scanned = {p.relative_to(REPO / "sheeprl_tpu_torch").as_posix() for p in _port_files()[:-1]}
    assert set(SAC_SLICE) <= scanned


# every registered entry point, and the pixel env of those that need one
ENTRY_POINTS = {
    "dreamer_v3": ["env=pixel_catcher", "env.id=pixel_catcher"],
    "ppo": [],
    "a2c": [],
    "ppo_recurrent": [],
    "sac": [],
    "droq": [],
    "sac_ae": ["env=pixel_pendulum", "env.id=PixelPendulum-v0"],
}


@pytest.mark.parametrize("module", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(module, monkeypatch):
    """``main`` and ``evaluate`` with no device (and the SAC family's
    ``build_agent``) ask for the CUDA card: without one they raise, with no
    CPU fallback."""
    import importlib

    import torch

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.utils import dotdict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pkg = f"sheeprl_tpu_torch.algos.{module}"
    train, evaluate = (importlib.import_module(f"{pkg}.{m}") for m in (module, "evaluate"))
    cfg = dotdict(compose("config", [f"exp={module}", "env.capture_video=False", *ENTRY_POINTS[module]]))
    calls = [lambda: train.main(cfg), lambda: evaluate.evaluate(cfg)]
    if module in ("sac", "droq", "sac_ae"):
        calls.append(lambda: importlib.import_module(f"{pkg}.agent").build_agent(cfg, None, None))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()


def test_the_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom sheeprl_tpu.ops import math\nimport sheeprl_tpu_torch\n")
    assert [r for r, _ in _imported_roots(f) if r in FORBIDDEN] == ["sheeprl_tpu"]


def test_package_runs_with_jax_and_friends_blocked():
    code = f"""
import sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None  # any import of it raises ImportError
from sheeprl_tpu_torch.configs import compose
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate
cfg = compose("XS", overrides={{
    "algo.dense_units": 16, "algo.mlp_layers": 1,
    "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 16,
    "algo.world_model.transition_model.hidden_size": 16,
    "algo.world_model.representation_model.hidden_size": 16,
    "algo.world_model.stochastic_size": 4, "algo.world_model.discrete_size": 4,
    "env.screen_size": 16, "env.max_episode_steps": 4}})
reward, steps = evaluate(cfg, device="cpu")
assert steps == 4, steps
# PPO on the port's own CartPole-v1 (gymnasium.make is the config's target)
from sheeprl_tpu_torch.algos.ppo.evaluate import evaluate as ppo_evaluate
from sheeprl_tpu_torch.config import compose as compose_config
from sheeprl_tpu_torch.utils.utils import dotdict
cfg = dotdict(compose_config("config", ["exp=ppo", "env.capture_video=False", "env.max_episode_steps=5"]))
reward, steps = ppo_evaluate(cfg, device="cpu")
assert steps == 5, steps
# A2C and recurrent PPO on it too
from sheeprl_tpu_torch.algos.a2c.evaluate import evaluate as a2c_evaluate
from sheeprl_tpu_torch.algos.ppo_recurrent.evaluate import evaluate as rppo_evaluate
for exp, run in (("a2c", a2c_evaluate), ("ppo_recurrent", rppo_evaluate)):
    cfg = dotdict(compose_config("config", [f"exp={{exp}}", "env.capture_video=False", "env.max_episode_steps=5"]))
    reward, steps = run(cfg, device="cpu")
    assert steps == 5, (exp, steps)
# the SAC family: SAC and DroQ on the port's Pendulum-v1, SAC-AE on PixelPendulum
from sheeprl_tpu_torch.algos.sac.evaluate import evaluate as sac_evaluate
from sheeprl_tpu_torch.algos.droq.evaluate import evaluate as droq_evaluate
from sheeprl_tpu_torch.algos.sac_ae.evaluate import evaluate as sac_ae_evaluate
for exp, run, extra in (
    ("sac", sac_evaluate, []),
    ("droq", droq_evaluate, []),
    ("sac_ae", sac_ae_evaluate, ["env=pixel_pendulum", "env.id=PixelPendulum-v0", "algo.cnn_channels_multiplier=1", "algo.hidden_size=16"]),
):
    cfg = dotdict(compose_config("config", [f"exp={{exp}}", "env.capture_video=False", "env.max_episode_steps=5", *extra]))
    reward, steps = run(cfg, device="cpu")
    assert steps == 5, (exp, steps)
import chip_smoke
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
