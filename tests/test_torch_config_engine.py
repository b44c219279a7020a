"""The port's config engine against the JAX package's: its YAML reader
against ``config.compose._yaml_load`` on every file of the JAX config tree,
a ``yaml.safe_dump`` of a composed config and a set of override values; the
composed tree of every ``exp`` the JAX composer accepts (with the
``_target_``s mapped to ``sheeprl_tpu_torch``); the override grammar and its
errors; the port's copy of the tree; and ``instantiate`` of an unported
``_target_``."""

import math
import os
from pathlib import Path

import pytest
import yaml

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config.compose import ConfigCompositionError as JaxCompositionError
from sheeprl_tpu.config.compose import MissingMandatoryValue as JaxMissing
from sheeprl_tpu.config.compose import _yaml_load as jax_yaml_load
from sheeprl_tpu_torch.config import compose, instantiate, load_config_file
from sheeprl_tpu_torch.config.compose import ConfigCompositionError, MissingMandatoryValue, group_options
from sheeprl_tpu_torch.config.reader import YAMLError, load

REPO = Path(__file__).resolve().parents[1]
JAX_TREE = REPO / "sheeprl_tpu" / "configs"
PORT_TREE = REPO / "sheeprl_tpu_torch" / "configs"
JAX_FILES = sorted(p.relative_to(JAX_TREE) for p in JAX_TREE.rglob("*.yaml"))


def _same(a, b):
    """Equal values, NaN equal to NaN, and types kept (1 is not True)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _retarget(node):
    """The JAX tree with each ``_target_: sheeprl_tpu.`` as the port's."""
    if isinstance(node, dict):
        out = {k: _retarget(v) for k, v in node.items()}
        target = out.get("_target_")
        if isinstance(target, str) and target.startswith("sheeprl_tpu."):
            out["_target_"] = "sheeprl_tpu_torch." + target[len("sheeprl_tpu.") :]
        return out
    if isinstance(node, list):
        return [_retarget(v) for v in node]
    return node


def test_the_tree_is_the_whole_jax_tree():
    assert len(JAX_FILES) == 120
    assert sorted(p.relative_to(PORT_TREE) for p in PORT_TREE.rglob("*.yaml")) == JAX_FILES


@pytest.mark.parametrize("rel", JAX_FILES, ids=str)
def test_reader_equals_the_jax_loader(rel):
    text = (JAX_TREE / rel).read_text()
    assert _same(load(text), jax_yaml_load(text))
    # the port's copy differs only in its _target_ prefixes
    assert _same(load((PORT_TREE / rel).read_text()), _retarget(jax_yaml_load(text)))


def test_reader_reads_a_safe_dump_of_a_composed_config():
    cfg = jax_compose("config", ["exp=dreamer_v3", "env=pixel_catcher", "run_name=x"]).to_dict()
    cfg["odd"] = {
        "long": "x" * 100 + " " + "y" * 40,
        "multi": "a\n\nb c",
        "quoted": "it's 'q' \"dq\"\t",
        "looks_like": ["1e5", "yes", "0755", "null", "~", "2001-12-14", "a: b", "#x", " lead"],
        "nested": [[1, 2], [3], {"k": [4, {"v": None}]}],
        "floats": [1e-5, float("inf"), -0.5, 3.0],
        "empty": [{}, []],
    }
    for sort_keys in (True, False):
        text = yaml.safe_dump(cfg, sort_keys=sort_keys)
        assert _same(load(text), jax_yaml_load(text))


OVERRIDE_VALUES = [
    "3e-4", "1e5", "1.5e3", "-.5", ".inf", "null", "~", "", "yes", "Off", "True", "0755", "0x1F", "1_000",
    "32-true", "bf16-mixed", "[a,b]", "[1, [2, 3], {a: 1}]", "{k: v}", "{a: [1, 2]}", "'it''s'", '"quoted str"',
    '"a\\tb"', "tcp://localhost:1234", "x # c", "2001-12-14", "a: b",
]  # fmt: skip


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_reader_reads_override_values_as_the_jax_loader(raw):
    assert _same(load(raw), jax_yaml_load(raw))


@pytest.mark.parametrize("raw", ["[a", "{a: 1", "'open", "a: b: c"])
def test_reader_rejects_what_the_jax_loader_rejects(raw):
    with pytest.raises(yaml.YAMLError):
        jax_yaml_load(raw)
    with pytest.raises(YAMLError):
        load(raw)


def _exps():
    return sorted(os.path.splitext(p.name)[0] for p in (JAX_TREE / "exp").glob("*.yaml"))


@pytest.mark.parametrize("exp", _exps())
def test_composed_tree_equals_the_jax_composer(exp):
    overrides = [f"exp={exp}", "run_name=x"]
    try:
        want = jax_compose("config", overrides)
    except JaxCompositionError as e:
        with pytest.raises(ConfigCompositionError) as got:
            compose("config", overrides)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e).replace("sheeprl_tpu/", "sheeprl_tpu_torch/")
        return
    assert _same(compose("config", overrides).to_dict(), _retarget(want.to_dict()))


OVERRIDE_CASES = [
    ["exp=dreamer_v3", "env=pixel_catcher", "fabric=cpu", "algo=dreamer_v3_XS"],
    ["exp=dreamer_v3", "env=dummy", "env.id=dummy_continuous", "+algo.extra=[1,2]", "~buffer.validate_args"],
    ["exp=dreamer_v3", "env=pixel_catcher", "algo.actor.optimizer.lr=3e-4", "metric.log_every=1e5", "seed=7"],
    ["exp=ppo", "env=dummy", "fabric.precision=32-true", "+new={a: 1}", "~env.variants"],
]


@pytest.mark.parametrize("overrides", OVERRIDE_CASES)
def test_overrides_compose_as_in_jax(overrides):
    overrides = overrides + ["run_name=x"]
    assert _same(compose("config", overrides).to_dict(), _retarget(jax_compose("config", overrides).to_dict()))


@pytest.mark.parametrize(
    "overrides, error",
    [
        (["run_name=x"], MissingMandatoryValue),  # exp: ???
        (["exp=dreamer_v3", "run_name=x"], MissingMandatoryValue),
        (["exp=dreamer_v3", "env=pixel_catcher", "algo.nope=1"], ConfigCompositionError),
        (["exp=dreamer_v3", "env=pixel_catcher", "~nope"], ConfigCompositionError),
        (["exp=dreamer_v3", "env=no_such_env"], ConfigCompositionError),
        (["exp=dreamer_v3", "noequals"], ConfigCompositionError),
    ],
)
def test_errors_match_the_jax_composer(overrides, error):
    jax_error = {MissingMandatoryValue: JaxMissing, ConfigCompositionError: JaxCompositionError}[error]
    try:
        jax_compose("config", overrides)
        jax_raised = None
    except JaxCompositionError as e:
        jax_raised = e
    try:
        compose("config", overrides)
        raised = None
    except ConfigCompositionError as e:
        raised = e
    assert (raised is None) == (jax_raised is None)
    if raised is not None:
        assert isinstance(jax_raised, jax_error) == isinstance(raised, error)
        assert type(raised).__name__ == type(jax_raised).__name__


def test_group_options_list_the_port_tree():
    assert "pixel_catcher" in group_options("env") and "cpu" in group_options("fabric")


@pytest.mark.parametrize(
    "node",
    [
        {"_target_": "gymnasium.make", "id": "CartPole-v1"},
        {"_target_": "sheeprl_tpu_torch.envs.crafter.CrafterWrapper"},
        {"_target_": "sheeprl_tpu_torch.ops.optim.lamb"},
        {"_target_": "sheeprl_tpu.utils.metric.MeanMetric"},
    ],
)
def test_an_unported_target_raises_not_implemented(node):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        instantiate(node)


def test_ported_targets_instantiate():
    cfg = compose("config", ["exp=dreamer_v3", "env=pixel_catcher", "fabric=cpu", "run_name=x"])
    aggregator = instantiate(cfg.metric.aggregator)
    assert "Loss/world_model_loss" in aggregator.metrics
    env = instantiate(cfg.env.wrapper)
    assert env.observation_space["rgb"].shape == (64, 64, 3)


@pytest.mark.parametrize("writer", ["json", "safe_dump"])
def test_stored_config_reads_either_package(tmp_path, writer):
    import json

    cfg = jax_compose("config", ["exp=dreamer_v3", "env=pixel_catcher", "run_name=x"]).to_dict()
    path = tmp_path / "config.yaml"
    path.write_text(json.dumps(cfg, indent=2) if writer == "json" else yaml.safe_dump(cfg, sort_keys=False))
    want = json.loads(path.read_text()) if writer == "json" else jax_yaml_load(path.read_text())
    assert _same(load_config_file(str(path)).to_dict(), want)
    assert _same(want, cfg)
