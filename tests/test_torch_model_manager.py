"""The port's model registry (``utils/model_manager.py``, the algorithms'
``log_models_from_checkpoint`` hooks, ``cli.registration`` and
``compose_model_manager_group``) against the JAX package's.

The same checkpoint, a seeded numpy tree in the JAX package's layout, is
registered by both packages' ``LocalModelManager``: their ``registry.json``
files are equal up to the author and date lines of each changelog and the
registry directory each artifact path starts with, and their artifact trees
(the registered copies and ``_artifacts``) are equal byte for byte.
``model_manager.backend=mlflow`` raises what the JAX package raises where
mlflow is absent (it is absent here and on the card's machine).
"""

import importlib
import json
import os
import pickle
import re
from pathlib import Path

import numpy as np
import pytest

from sheeprl_tpu import cli as jax_cli
from sheeprl_tpu.utils import model_manager as jax_mm
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.utils import model_manager as mm
from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict, save_configs

# every ported algorithm: its package, and its registered sub-models sit
# under the checkpoint's top level or its "agent" node
ALGORITHMS = {
    "dreamer_v3": "dreamer_v3",
    "dreamer_v2": "dreamer_v2",
    "dreamer_v1": "dreamer_v1",
    "p2e_dv3_exploration": "p2e_dv3",
    "p2e_dv3_finetuning": "p2e_dv3",
    "p2e_dv2_exploration": "p2e_dv2",
    "p2e_dv2_finetuning": "p2e_dv2",
    "p2e_dv1_exploration": "p2e_dv1",
    "p2e_dv1_finetuning": "p2e_dv1",
    "ppo": "ppo",
    "a2c": "a2c",
    "ppo_recurrent": "ppo_recurrent",
    "sac": "sac",
    "droq": "droq",
    "sac_ae": "sac_ae",
}
_DATE = re.compile(r"\*\*Author\*\*: .*\n\*\*Date\*\*: .*\n")


def _tree(rng, depth=2):
    """A nested params tree of float32 arrays (flax's layout)."""
    if depth == 0:
        return rng.standard_normal((3, 4)).astype(np.float32)
    return {"params": {f"Dense_{i}": {"kernel": _tree(rng, 0), "bias": rng.standard_normal(4).astype(np.float32)} for i in range(depth)}}


def _checkpoint(models, nested_agent=False, seed=0):
    rng = np.random.default_rng(seed)
    trees = {k: _tree(rng) for k in sorted(models)}
    state = {"agent": trees} if nested_agent and set(models) != {"agent"} else dict(trees)
    state.update({"update": 7, "rng_key": np.arange(2, dtype=np.uint32), "actor_optimizer": (np.zeros(3, np.float32),)})
    return state


def _normalized(registry_dir):
    with open(os.path.join(registry_dir, "registry.json")) as f:
        index = json.load(f)
    for versions in index.values():
        for v in versions:
            v["changelog"] = _DATE.sub("", v["changelog"])
            if v["artifact"]:
                v["artifact"] = os.path.relpath(v["artifact"], registry_dir)
    return index


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*.pkl"))}


def _mm_cfg(name, jax_side, registry_dir, exp_name="run_x", env_id="Env-v0"):
    base = dotdict({"exp_name": exp_name, "env": {"id": env_id}, "algo": {"name": name}})
    group = (jax_cli if jax_side else cli).compose_model_manager_group(name, base)
    group["registry_dir"] = str(registry_dir)
    base["model_manager"] = group
    return base


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_registration_matches_the_jax_packages(name, tmp_path):
    """Each algorithm's composed model-manager group, its hook and the
    registration of one checkpoint: registries and artifacts equal."""
    pkg = ALGORITHMS[name]
    jutils = importlib.import_module(f"sheeprl_tpu.algos.{pkg}.utils")
    tutils = importlib.import_module(f"sheeprl_tpu_torch.algos.{pkg}.utils")
    assert tutils.MODELS_TO_REGISTER == jutils.MODELS_TO_REGISTER
    jcfg, tcfg = _mm_cfg(name, True, tmp_path / "jax"), _mm_cfg(name, False, tmp_path / "port")
    assert {k: v for k, v in tcfg.model_manager.items() if k != "registry_dir"} == {
        k: v for k, v in jcfg.model_manager.items() if k != "registry_dir"
    }
    # finetuning checkpoints lack the exploration-only models; the registry
    # registers the configured ones, a subset of what the checkpoint holds
    state = _checkpoint(tutils.MODELS_TO_REGISTER, nested_agent=pkg in ("ppo", "a2c", "ppo_recurrent", "sac", "droq"))
    jax_mm.register_model_from_checkpoint(None, jcfg, state, jutils.log_models_from_checkpoint)
    mm.register_model_from_checkpoint(None, tcfg, state, tutils.log_models_from_checkpoint)
    assert _normalized(tmp_path / "port") == _normalized(tmp_path / "jax")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") and _files(tmp_path / "port")


def test_a_missing_configured_model_raises_as_the_jax_package(tmp_path):
    state = _checkpoint({"world_model", "actor"})
    errors = []
    for side, module in ((True, jax_mm), (False, mm)):
        cfg = _mm_cfg("dreamer_v3", side, tmp_path / str(side))
        utils = importlib.import_module(f"sheeprl_tpu{'' if side else '_torch'}.algos.dreamer_v3.utils")
        with pytest.raises(RuntimeError) as err:
            module.register_model_from_checkpoint(None, cfg, state, utils.log_models_from_checkpoint)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "subset" in errors[1]


def test_the_local_registry_lifecycle_matches(tmp_path):
    art = tmp_path / "model.pkl"
    art.write_bytes(pickle.dumps({"w": np.ones(3, np.float32)}))
    managers = {"jax": jax_mm.LocalModelManager(None, str(tmp_path / "jax")), "port": mm.LocalModelManager(None, str(tmp_path / "port"))}
    for m in managers.values():
        m.register_model(str(art), "m", "first", {"k": "v"})
        m.register_model(str(art), "m", "second")
        m.transition_model("m", 1, "Production", "promoted")
        m.delete_model("m", 2)
        m.download_model("m", 1, str(tmp_path / "dl" / type(m).__module__))
        assert m.get_latest_version("m")["stage"] == "Deleted"
        with pytest.raises(KeyError):
            m.get_latest_version("absent")
        with pytest.raises(FileNotFoundError):
            m.download_model("m", 2, str(tmp_path))
    assert _normalized(tmp_path / "port") == _normalized(tmp_path / "jax")
    assert (tmp_path / "dl" / mm.__name__ / "model.pkl").read_bytes() == art.read_bytes()


@pytest.mark.parametrize("tracking_uri", [None, "http://127.0.0.1:5000"])
def test_the_mlflow_backend_raises_as_the_jax_package_does_without_mlflow(tracking_uri, monkeypatch):
    monkeypatch.delenv("MLFLOW_TRACKING_URI", raising=False)
    monkeypatch.setattr(jax_mm, "_IS_MLFLOW_AVAILABLE", False)
    cfg = {"model_manager": {"backend": "mlflow", "tracking_uri": tracking_uri}}
    raised = []
    for module in (jax_mm, mm):
        with pytest.raises(Exception) as err:
            module.make_model_manager(None, cfg)
        raised.append((type(err.value), str(err.value)))
    assert raised[0] == raised[1]
    assert raised[1][0] is (ValueError if tracking_uri is None else ModuleNotFoundError)
    assert "mlflow" in raised[1][1].lower()


def test_an_unknown_backend_raises_as_the_jax_package():
    cfg = {"model_manager": {"backend": "s3"}}
    with pytest.raises(ValueError) as jerr:
        jax_mm.make_model_manager(None, cfg)
    with pytest.raises(ValueError) as terr:
        mm.make_model_manager(None, cfg)
    assert str(terr.value) == str(jerr.value)


def test_cli_registration_matches_the_jax_packages(tmp_path):
    """``cli_registration`` of one run's checkpoint in both packages: the
    stored config read back, the algorithm's group composed, the override
    applied, the same registry and artifacts."""
    cfg = dotdict(compose("config", ["exp=ppo", "fabric=cpu", "env.capture_video=False"]))
    run = tmp_path / "run" / "version_0"
    save_configs(cfg, str(run))
    state = _checkpoint({"agent"})
    ckpt = run / "checkpoint" / "ckpt_8_0.ckpt"
    save_checkpoint(str(ckpt), state)
    jax_cli.registration([f"checkpoint_path={ckpt}", f"model_manager.registry_dir={tmp_path / 'jax'}"])
    cli.registration([f"checkpoint_path={ckpt}", f"model_manager.registry_dir={tmp_path / 'port'}"])
    assert list(_normalized(tmp_path / "port")) == [f"{cfg.exp_name}_agent"]
    assert _normalized(tmp_path / "port") == _normalized(tmp_path / "jax")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    with open(tmp_path / "port" / f"{cfg.exp_name}_agent" / "v1" / "agent.pkl", "rb") as f:
        got = pickle.load(f)
    np.testing.assert_array_equal(got["params"]["Dense_0"]["kernel"], state["agent"]["params"]["Dense_0"]["kernel"])


def test_cli_registration_needs_a_checkpoint_path():
    with pytest.raises(ValueError, match="checkpoint_path"):
        cli.registration([])
