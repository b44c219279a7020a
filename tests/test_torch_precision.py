"""The port at ``bf16-mixed``, the precision ``exp=dreamer_v3`` composes
(``configs/fabric/default.yaml``), against the JAX package at the same
precision on the CPU.

The JAX modules are built by the JAX ``build_agent`` under a ``Fabric`` at
``bf16-mixed`` (fp32 params, bf16 compute), their params shifted by seeded
numpy noise and carried across with ``convert``; inputs are made with numpy
from a seed. Tiny widths (``tests/test_torch_dv3_train.py::TINY``), the JAX
side jitted.

What is compared, per entry point (``WorldModel`` entry points, actor,
critic) and per product layer inside it (each Dense and convolution the
entry point runs, by its flax path; flax's ``capture_intermediates``
against forward hooks):

- each output's dtype equals the JAX output's, and each product layer's
  output dtype equals the flax layer's: a layer missing its cast computes
  in fp32 where flax computes in bf16, which this sees exactly;
- ``LAYER_TOL`` on the first product layers of an entry point, which both
  packages feed the same inputs: the bf16 product, summed in fp32 and
  rounded once, then the bias added and rounded, is the same value in
  both (measured: bit-equal);
- ``ENTRY_TOL`` on each entry point's outputs relative to max(|JAX|, 1):
  past the first layer the two packages round the elementwise chains at
  other places (XLA rounds inside its expansion of ``silu`` and
  ``sigmoid``, PyTorch once; JAX jitted and eager differ by up to 6 x 2^-8
  on one Dense-LayerNorm-SiLU block), so this bound is the bf16 noise of a
  few layers, not a test of the casts.

The control: the same modules computed in fp32 (``32-true``) fail the
layer check: their first products differ by 0.68-1.29 x 2^-8 and their
layers' dtypes are fp32. Their entry outputs (up to 5.7 x 2^-8) are no
farther from the bf16 JAX modules than the bf16 port's (3.5 x 2^-8): the
entry bound alone could not see a missing cast.

The RSSM step is held apart: the port's plain ``RecurrentModel``
(``fused: flax``) against the flax cell, and the port's ``auto`` (the fused
step; on CPU tensors its plain version) against JAX ``fused=pallas`` in
interpret mode. At bf16-mixed both fused steps take a bf16 ``x`` and fp32
``h`` and compute in fp32, so they keep the fp32 bounds (1e-5 forward,
1e-4 gradients) and return ``dx`` in bf16; the flax cell rounds ``h`` to
bf16 inside the step (``STEP_TOL``). Then one ``local_train`` step,
discrete and continuous, with the deterministic sampler of
``tests/test_torch_dv3_train.py`` (``TRAIN_TOL``).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jdv3
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu.ops import pallas_gru as jgru
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.parallel.fabric import Precision as JaxPrecision
from sheeprl_tpu.utils.utils import dotdict
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.sac_ae import agent as tagent_ae
from sheeprl_tpu_torch.algos.dreamer_v3.convert import (
    _world_model_path,
    actor_from_flax,
    actor_to_flax,
    critic_from_flax,
    critic_to_flax,
    world_model_from_flax,
)
from sheeprl_tpu_torch.configs import compose
from sheeprl_tpu_torch.device import Precision, compute_dtype
from sheeprl_tpu_torch.models.blocks import Conv2d, ConvTranspose2d, Dense, LayerNormGRUCell
from sheeprl_tpu_torch.ops import fused_gru as tgru
from sheeprl_tpu_torch.ops import math as tm
from tests.test_torch_dv3_train import (  # noqa: F401  (deterministic is a fixture)
    _jax_tx,
    _perturb,
    _recording,
    batch,
    deterministic,
    obs_space,
    port_modules,
    tiny_cfg,
)

EPS = 2.0**-8  # bf16's unit roundoff
# first product layers, fed the same inputs on both sides: measured 0
# (bit-equal) in every case; the fp32 control 0.68-1.29 x 2^-8
LAYER_TOL = 0.25 * EPS
# entry-point outputs relative to max(|JAX|, 1): measured up to 3.5 x 2^-8
# (encode; decode 3.4, continue 1.4, dynamic 1.1, the rest under 1); the
# fp32 control up to 5.7 x 2^-8
ENTRY_TOL = 6 * EPS
# the plain RecurrentModel against the flax cell, h' relative to max(|h'|, 1)
# (both round h, the projection and the gates to bf16): measured 1.2 x 2^-8;
# gradients relative to each tensor's largest element: measured 4.2 x 2^-8
# (dx 1.9)
STEP_TOL = 3 * EPS
STEP_GRAD_TOL = 8 * EPS
# the fused step at bf16-mixed: fp32 arithmetic on a bf16 x, as fp32
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# one local_train step: the 13 metrics relative to max(|JAX|, 1), measured
# 0.14 / 0.17 x 2^-8 (discrete / continuous), and each gradient tensor
# relative to its largest element, through the scan, the decoders,
# imagination and three backward passes in bf16: measured 9.6 / 9.3 x 2^-8
# (the CNN encoder's LayerNorm gains; actor 2.8, critic 1.5)
TRAIN_TOL = 1 * EPS
TRAIN_GRAD_TOL = 16 * EPS

PRODUCT_LAYERS = (Dense, Conv2d, ConvTranspose2d, LayerNormGRUCell)


def t(a):
    return torch.as_tensor(np.asarray(a))


def bf16_cfg(precision="bf16-mixed", **extra):
    return tiny_cfg(**{"fabric.precision": precision, **extra})


def jax_agent(cfg, space, actions_dim, is_continuous, seed=0):
    """The JAX world model, actor and critic built by the JAX ``build_agent``
    under a Fabric at bf16-mixed, with perturbed params."""
    fabric = Fabric(devices=1, precision="bf16-mixed", accelerator="cpu")
    wm, wp, actor, ap, critic, cp, _, _ = jagent.build_agent(fabric, actions_dim, is_continuous, cfg, space)
    assert wm.dtype == actor.dtype == critic.dtype == jnp.bfloat16
    return wm, _perturb(wp, seed), actor, _perturb(ap, seed + 1), critic, _perturb(cp, seed + 2), _perturb(cp, seed + 3)


def rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def _flax_layers(tree, prefix=""):
    """{flax module path: [outputs of each call]} from captured intermediates."""
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            out[prefix] = [o[0] if isinstance(o, tuple) else o for o in v]
        else:
            out.update(_flax_layers(v, f"{prefix}/{k}" if prefix else k))
    return out


def _flax_path(kind, name, module, n_deconvs):
    """The flax module path of a port product layer, from the converter's
    names."""
    if isinstance(module, LayerNormGRUCell):
        return name.replace(".gru", "/LayerNormGRUCell_0")
    if kind == "world_model":
        return _world_model_path(f"{name}.weight", n_deconvs)[0].rsplit("/", 1)[0]
    to_flax = actor_to_flax if kind == "actor" else critic_to_flax
    node, path = to_flax({f"{name}.weight": module.weight})["params"], []
    while isinstance(node, dict):
        ((k, node),) = node.items()
        path.append(k)
    return "/".join(path[:-1])


def _nhwc(out):
    """A layer's output in flax's layout: convolutions NCHW -> NHWC."""
    out = out.detach()
    return out.permute(0, 2, 3, 1) if out.dim() == 4 else out


def run_with_layers(kind, module, fn):
    """``fn()`` with a forward hook on every product layer of ``module``:
    (result, {flax path: [outputs of each call]})."""
    n_deconvs = len([n for n, _ in module.named_modules() if n.startswith("cnn_decoder.deconvs.")])
    seen, hooks = {}, []
    for name, m in module.named_modules():
        if isinstance(m, PRODUCT_LAYERS):
            path = _flax_path(kind, name, m, n_deconvs)
            hooks.append(m.register_forward_hook(lambda _m, _a, o, p=path: seen.setdefault(p, []).append(_nhwc(o))))
    try:
        result = fn()
    finally:
        for h in hooks:
            h.remove()
    return result, seen


def same_dtype(got, want):
    return str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name


def check_layers(got, want, first):
    """(the layers whose output dtype differs from flax's, the worst error
    of the first layers' first calls) of the port's layer outputs against
    flax's; every port layer ran in flax as many times."""
    assert got and set(got) <= set(want), sorted(set(got) - set(want))
    assert all(len(got[p]) == len(want[p]) for p in got), {p: (len(got[p]), len(want[p])) for p in got}
    mismatched = sorted(p for p in got if not all(same_dtype(a, b) for a, b in zip(got[p], want[p])))
    assert all(p in got for p in first), [p for p in first if p not in got]
    worst = max((rel_err(got[p][0], want[p][0]) for p in first), default=0.0)
    return mismatched, worst


# --------------------------------------------------------------------------- #
# the precision policy
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["32-true", "32", "fp32", "bf16", "bf16-mixed", "bf16-true"])
def test_precision_policy_matches_jax(name):
    assert Precision(name).name == JaxPrecision(name).name
    assert str(Precision(name).compute_dtype).split(".")[-1] == jnp.dtype(JaxPrecision(name).compute_dtype).name
    assert str(Precision(name).param_dtype).split(".")[-1] == jnp.dtype(JaxPrecision(name).param_dtype).name
    assert compute_dtype(name) == Precision(name).compute_dtype


def test_bf16_true_and_unknown_precisions_raise():
    """An unknown precision raises. ``bf16-true`` no longer does: it is
    accepted, and Dreamer-V3 keeps fp32 parameters under it as the JAX
    modules do (``tests/test_torch_dv3_gaps.py`` holds its train step)."""
    with pytest.raises(ValueError):
        Precision("fp16")
    assert Precision("bf16-true").param_dtype == torch.bfloat16
    cfg = tiny_cfg(**{"fabric.precision": "bf16-true"})
    wm, actor, _ = tagent.build_agent((3,), False, cfg, obs_space(("rgb",), ("state",)), device="cpu")
    assert wm.dtype == actor.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in [*wm.parameters(), *actor.parameters()])


def test_default_precision_is_bf16_mixed():
    assert compose("S")["fabric"]["precision"] == "bf16-mixed"
    wm, actor, _ = tagent.build_agent((3,), False, compose("XS", overrides={"env.screen_size": 16}), obs_space(("rgb",), ()), device="cpu")
    assert wm.dtype == actor.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in [*wm.parameters(), *actor.parameters()])


# --------------------------------------------------------------------------- #
# the world-model entry points, the actor and the critic
# --------------------------------------------------------------------------- #

ENTRIES = {
    # entry point: the first product layers (flax paths), fed the same inputs
    "encode": ["cnn_encoder/Conv_0", "mlp_encoder/_LNMLP_0/Dense_0"],
    "decode": ["cnn_decoder/Dense_0", "mlp_decoder/_LNMLP_0/Dense_0"],
    "reward_logits": ["reward_model/layers_0/Dense_0"],
    "continue_logits": ["continue_model/layers_0/Dense_0"],
    "initial_state": ["transition_model/layers_0/Dense_0"],
    # the prior of the restarted state: transition_model's first call
    "dynamic": ["transition_model/layers_0/Dense_0"],
    "imagination": [],
    "actor": ["_LNMLP_0/Dense_0"],
    "critic": ["_LNMLP_0/Dense_0"],
}


@functools.lru_cache(maxsize=None)
def _entry_agent(jfused):
    """The JAX agent of the entry-point tests, built once a process."""
    jcfg = bf16_cfg(**{"algo.world_model.recurrent_model.fused": jfused})
    return jax_agent(jcfg, obs_space(("rgb",), ("state",)), (3,), False)


def _entry(entry, precision="bf16-mixed", fused="flax"):
    """(port outputs, JAX outputs, port layers, JAX layers) of one entry, the
    port at ``precision`` with recurrent backend ``fused``, the JAX modules
    at bf16-mixed with its counterpart (port ``auto``: JAX ``pallas``)."""
    space = obs_space(("rgb",), ("state",))
    cfg = bf16_cfg(precision, **{"algo.world_model.recurrent_model.fused": fused})
    jwm, wp, jact, ap, jcrit, cp, tp = _entry_agent("pallas" if fused == "auto" else "flax")
    twm, tact, tcrit, _ = port_modules(cfg, space, (3,), False, wp, ap, cp, tp)
    rng = np.random.default_rng(20)
    n = 5
    obs = {"rgb": rng.integers(0, 256, (n, 16, 16, 3)).astype(np.uint8), "state": (3 * rng.standard_normal((n, 5))).astype(np.float32)}
    lat = rng.standard_normal((n, twm.latent_state_size)).astype(np.float32)
    z = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, 4))].reshape(n, 16)
    h = np.tanh(rng.standard_normal((n, twm.recurrent_state_size))).astype(np.float32)
    a = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    emb = np.asarray(jax.jit(lambda p, o: jwm.apply(p, o, method=jagent.WorldModel.encode))(wp, obs))
    first = np.array([[1.0], [0.0], [0.0], [1.0], [0.0]], np.float32)
    key = jax.random.PRNGKey(0)
    calls = {
        "encode": ("world_model", twm, jwm, wp, (obs,), lambda: twm.encode({k: t(v) for k, v in obs.items()})),
        "decode": ("world_model", twm, jwm, wp, (lat,), lambda: twm.decode(t(lat))),
        "reward_logits": ("world_model", twm, jwm, wp, (lat,), lambda: twm.reward_logits(t(lat))),
        "continue_logits": ("world_model", twm, jwm, wp, (lat,), lambda: twm.continue_logits(t(lat))),
        "initial_state": ("world_model", twm, jwm, wp, ((n,),), lambda: twm.initial_state(n)),
        "dynamic": (
            "world_model", twm, jwm, wp, (z, h, a, emb, first, key),
            lambda: twm.dynamic(t(z), t(h), t(a), t(emb), t(first)),
        ),
        "imagination": ("world_model", twm, jwm, wp, (z, h, a, key), lambda: twm.imagination(t(z), t(h), t(a))),
        "actor": ("actor", tact, jact, ap, (lat,), lambda: tact(t(lat))),
        "critic": ("critic", tcrit, jcrit, cp, (lat,), lambda: tcrit(t(lat))),
    }
    kind, tmod, jmod, params, args, port_fn = calls[entry]
    if kind == "world_model":
        method = getattr(jagent.WorldModel, entry)
        jfn = lambda p, *a: jmod.apply(p, *a, method=method, capture_intermediates=True, mutable=["intermediates"])  # noqa: E731
        if entry == "initial_state":
            jfn = lambda p: jmod.apply(p, (n,), method=method, capture_intermediates=True, mutable=["intermediates"])  # noqa: E731
            args = ()
    else:
        jfn = lambda p, *a: jmod.apply(p, *a, capture_intermediates=True, mutable=["intermediates"])  # noqa: E731
    want, inter = jax.jit(jfn)(params, *args)
    with torch.no_grad():
        got, layers = run_with_layers(kind, tmod, port_fn)
    flat = lambda o: list(o.values()) if isinstance(o, dict) else list(o) if isinstance(o, (tuple, list)) else [o]  # noqa: E731
    return flat(got), flat(want), layers, _flax_layers(inter["intermediates"])


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_points_match_jax_at_bf16(entry, deterministic):
    got, want, layers, jlayers = _entry(entry)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert same_dtype(g, w) and g.shape == w.shape
        assert rel_err(g, w) <= ENTRY_TOL, (entry, rel_err(g, w) / EPS)
    mismatched, worst = check_layers(layers, jlayers, ENTRIES[entry])
    assert not mismatched, mismatched
    if ENTRIES[entry]:
        assert worst <= LAYER_TOL, worst / EPS


@pytest.mark.parametrize("entry", ["encode", "decode", "reward_logits", "actor", "critic"])
def test_fp32_control_fails_the_layer_check(entry, deterministic):
    """The same modules computed in fp32 fail the layer check: their product
    layers are fp32 and their first products are not the bf16 ones."""
    _, _, layers, jlayers = _entry(entry, "32-true")
    mismatched, worst = check_layers(layers, jlayers, ENTRIES[entry])
    assert mismatched and worst > LAYER_TOL, (mismatched, worst / EPS)


# --------------------------------------------------------------------------- #
# the RSSM step
# --------------------------------------------------------------------------- #


def _recurrent_state(tree):
    """A flax ``RecurrentModel`` tree as the port's state dict."""
    p = jax.tree.map(np.asarray, tree)["params"]
    cell = p["LayerNormGRUCell_0"]
    return {
        "in_kernel": t(p["Dense_0"]["kernel"]),
        "in_bias": t(p["Dense_0"]["bias"]),
        "in_norm.weight": t(p["LayerNorm_0"]["LayerNorm_0"]["scale"]),
        "in_norm.bias": t(p["LayerNorm_0"]["LayerNorm_0"]["bias"]),
        "gru.kernel": t(cell["Dense_0"]["kernel"]),
        "gru.norm.weight": t(cell["LayerNorm_0"]["LayerNorm_0"]["scale"]),
        "gru.norm.bias": t(cell["LayerNorm_0"]["LayerNorm_0"]["bias"]),
    }


def grad_err(got, want):
    """Largest difference relative to the reference tensor's largest element."""
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _step_inputs(seed=21, batch_=6, in_dim=20, dense=8, hidden=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch_, in_dim)).astype(np.float32)
    h = np.tanh(rng.standard_normal((batch_, hidden))).astype(np.float32)
    return x, h


def test_plain_recurrent_model_matches_the_flax_cell_at_bf16():
    """Port ``fused: flax`` against JAX ``fused=flax``: x cast to bf16, h
    rounded to bf16 inside the cell, h' back in fp32; forward and the
    gradients of x and every parameter."""
    x, h = _step_inputs()
    jm_ = jagent.RecurrentModel(8, 8, dtype=jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    params = _perturb(jm_.init(jax.random.PRNGKey(4), xb, jnp.asarray(h)), 4)
    loss = lambda p, x_: jnp.sum(jnp.square(jm_.apply(p, x_, jnp.asarray(h))))  # noqa: E731
    want = jax.jit(jm_.apply)(params, xb, jnp.asarray(h))
    jg, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, xb)
    model = tagent.RecurrentModel(20, 8, 8, dtype=torch.bfloat16)
    model.load_state_dict(_recurrent_state(params))
    xt = t(x).bfloat16().requires_grad_(True)
    out = model(xt, t(h))
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel_err(out, want) <= STEP_TOL, rel_err(out, want) / EPS
    out.square().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and jgx.dtype == jnp.bfloat16
    grads = _recurrent_state(jg)
    for name, p in model.named_parameters():
        assert grad_err(p.grad, grads[name]) <= STEP_GRAD_TOL, (name, grad_err(p.grad, grads[name]) / EPS)
    assert grad_err(xt.grad, jgx) <= STEP_GRAD_TOL, grad_err(xt.grad, jgx) / EPS


def test_fused_step_takes_bf16_x_as_the_pallas_kernel():
    """Port ``auto`` (the fused step; its plain version on CPU tensors)
    against JAX ``fused=pallas`` in interpret mode, x in bf16 and h in fp32:
    fp32 arithmetic on both sides, so fp32 bounds; dx comes back in bf16."""
    rng = np.random.default_rng(22)
    x, h = _step_inputs()
    n = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    w = [n(20, 8), n(8), 1 + n(8), n(8), n(16, 24), 1 + n(24), n(24)]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    loss = lambda xx, *ww: jnp.sum(jnp.square(jgru.fused_recurrent_step(xx, jnp.asarray(h), *ww, interpret=True)))  # noqa: E731
    want = jax.jit(lambda xx, *ww: jgru.fused_recurrent_step(xx, jnp.asarray(h), *ww, interpret=True))(xb, *w)
    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(xb, *w)
    xt = t(x).bfloat16().requires_grad_(True)
    wt = [t(a).requires_grad_(True) for a in w]
    before = tgru.launch_count
    out = tgru.fused_recurrent_step(xt, t(h), *wt)
    assert tgru.launch_count == before  # CPU tensors: the plain version
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    out.square().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and jgrads[0].dtype == jnp.bfloat16
    # dx is the fp32 gradient rounded to bf16 on both sides: at most one
    # bf16 ulp (2^-7 relative) apart where the fp32 sums straddle a rounding
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(jgrads[0], np.float32), atol=GRAD_TOL, rtol=2 * EPS)
    for a, b in zip(wt, jgrads[1:]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_fused_wrapper_takes_fp32_or_bf16_x_and_fp32_everything_else():
    rng = np.random.default_rng(23)
    args = [t(rng.standard_normal(s).astype(np.float32)) for s in ((3, 5), (3, 4), (5, 6), (6,), (6,), (6,), (10, 12), (12,), (12,))]
    ref = tgru.reference_step(*args)
    torch.testing.assert_close(tgru.fused_recurrent_step(args[0].bfloat16(), *args[1:]), tgru.reference_step(args[0].bfloat16(), *args[1:]))
    assert not torch.equal(tgru.reference_step(args[0].bfloat16(), *args[1:]), ref)  # x really is rounded
    for i, dtype in ((0, torch.float16), (1, torch.bfloat16), (2, torch.bfloat16), (6, torch.bfloat16)):
        bad = list(args)
        bad[i] = bad[i].to(dtype)
        with pytest.raises(TypeError):
            tgru.fused_recurrent_step(*bad)


@pytest.mark.parametrize("tfused", ["auto", "flax"])
def test_fused_model_passes_bf16_x_to_the_step(tfused, deterministic):
    """In the world model, the port's recurrent model sees x in bf16 as the
    JAX one does; ``auto`` hands it to the fused wrapper uncast, and matches
    JAX ``pallas`` as fp32 does (measured 1.5e-5 x 2^-8)."""
    seen = []
    orig = tgru._FusedStep.forward

    def spy(ctx, eps1, eps2, *args):
        seen.append((args[0].dtype, args[1].dtype))
        return orig(ctx, eps1, eps2, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgru._FusedStep, "forward", staticmethod(spy))
        got, want, _, _ = _entry("imagination", fused=tfused)
    assert seen == ([(torch.bfloat16, torch.float32)] if tfused == "auto" else [])
    for g, w in zip(got, want):
        assert rel_err(g, w) <= (FWD_TOL if tfused == "auto" else ENTRY_TOL)


# --------------------------------------------------------------------------- #
# one local_train step
# --------------------------------------------------------------------------- #


def _jax_train(wm, actor, critic, params, cfg, d, is_continuous, actions_dim):
    """One jitted JAX ``local_train`` step: (metrics, {model: gradients}, Moments)."""
    algo = cfg["algo"]
    txs = [_recording(_jax_tx(algo[k]["optimizer"], algo[k]["clip_gradients"])) for k in ("world_model", "actor", "critic")]
    fabric = types.SimpleNamespace(data_axis="data", world_size=1, model_axis=None)
    local_train, _ = jdv3.make_train_step(fabric, wm, actor, critic, *txs, dotdict(cfg), is_continuous, actions_dim)
    wp, ap, cp, tp = params
    opt_states = [tx.init(p) for tx, p in zip(txs, (wp, ap, cp))]
    data = {k: jnp.asarray(v) for k, v in d.items()}
    *_, o_wm, o_actor, o_critic, moments, metrics = jax.jit(local_train)(
        wp, ap, cp, tp, *opt_states, jm.init_moments(), data, jax.random.PRNGKey(0)
    )
    grads = {
        "world_model": world_model_from_flax(o_wm[1]),
        "actor": actor_from_flax(o_actor[1]),
        "critic": critic_from_flax(o_critic[1]),
    }
    return np.asarray(metrics), grads, moments


# the JAX gradient of the CNN decoder's output bias is a sum of T x B x 16 x
# 16 bf16 cotangents a channel, which the JAX step on the CPU accumulates in
# bf16: its norm is 0.77 of its own fp32 step's (measured), where the port
# sums in fp32 (within 0.6 x 2^-8 of the JAX fp32 gradient). That tensor and
# the world-model gradient norm it enters are held to the JAX fp32 step.
FP32_SUMMED = "cnn_decoder.out.bias"


@pytest.mark.parametrize(
    "actions_dim, is_continuous, env", [((3,), False, "dummy_discrete"), ((2,), True, "dummy_continuous")]
)
def test_train_step_matches_jax_at_bf16(actions_dim, is_continuous, env, deterministic):
    """One gradient step through both packages at bf16-mixed from the same
    weights and batch: the 13 metrics, the three models' gradients (fp32,
    as the params) and the Moments. The port's recurrent step is the fused
    wrapper, the JAX one the Pallas kernel in interpret mode."""
    cfg = bf16_cfg(env=env)
    space = obs_space(("rgb",), ("state",))
    jcfg = bf16_cfg(env=env, **{"algo.world_model.recurrent_model.fused": "pallas"})
    jwm, wp, jact, ap, jcrit, cp, tp = jax_agent(jcfg, space, actions_dim, is_continuous)
    twm, tact, tcrit, ttarget = port_modules(cfg, space, actions_dim, is_continuous, wp, ap, cp, tp)
    assert twm.fused and twm.dtype == torch.bfloat16
    d = batch(("rgb",), ("state",), actions_dim, is_continuous, seed=11)
    params = (wp, ap, cp, tp)
    j_metrics, j_grads, j_moments = _jax_train(jwm, jact, jcrit, params, jcfg, d, is_continuous, actions_dim)
    fp32 = (jwm.clone(dtype=jnp.float32), jact.clone(dtype=jnp.float32), jagent.make_critic(dict(jcfg["algo"]["critic"]), jnp.float32))
    j32_metrics, j32_grads, _ = _jax_train(*fp32, params, jcfg, d, is_continuous, actions_dim)

    opts = tdv3.build_optimizers(cfg, twm, tact, tcrit)
    step = tdv3.make_train_step(twm, tact, tcrit, ttarget, *opts, cfg, is_continuous)
    grads = {}
    t_moments, t_metrics = step(tm.init_moments(), {k: t(v) for k, v in d.items()}, None, grads)
    assert t_metrics.dtype == torch.float32 and j_metrics.dtype == np.float32
    wm_norm = tdv3.METRIC_ORDER.index("Grads/world_model")
    rest = [i for i in range(len(tdv3.METRIC_ORDER)) if i != wm_norm]
    assert rel_err(t_metrics[rest], j_metrics[rest]) <= TRAIN_TOL, rel_err(t_metrics[rest], j_metrics[rest]) / EPS
    assert rel_err(t_metrics[wm_norm], j32_metrics[wm_norm]) <= TRAIN_TOL
    assert rel_err(t_moments.low, j_moments.low) <= TRAIN_TOL
    assert rel_err(t_moments.high, j_moments.high) <= TRAIN_TOL
    modules = {"world_model": twm, "actor": tact, "critic": tcrit}
    for name, module in modules.items():
        got = dict(zip([n for n, _ in module.named_parameters()], grads[name]))
        assert got.keys() == j_grads[name].keys()
        for k, want in j_grads[name].items():
            if name == "world_model" and k == FP32_SUMMED:
                assert grad_err(want, j32_grads[name][k]) > TRAIN_GRAD_TOL  # the JAX bf16 sum
                want = j32_grads[name][k]
            assert got[k].dtype == torch.float32
            assert grad_err(got[k], want) <= TRAIN_GRAD_TOL, (name, k, grad_err(got[k], want) / EPS)


def test_main_trains_at_bf16_mixed_on_cpu(tmp_path):
    """main() at the default precision on the CPU: finite metrics, the
    modules computing in bf16."""
    cfg = bf16_cfg(**{"env.num_envs": 2, "buffer.size": 64, "algo.learning_starts": 8, "algo.total_steps": 24}, log_base_dir=str(tmp_path))
    out = tdv3.main(cfg, device="cpu")
    assert out["gradient_steps"] == 1 + 2 * 8
    assert all(np.isfinite(v) for v in out["metrics"].values())


# --------------------------------------------------------------------------- #
# the SAC family (SAC, DroQ, SAC-AE): each product layer at bf16-mixed
# --------------------------------------------------------------------------- #

# entry: the first product layers (flax paths), fed the same inputs
SAC_FAMILY = {
    "sac_actor": ["Dense_0"],
    "sac_critics": ["Dense_0"],
    "droq_critics": ["Dense_0"],
    "sac_ae_encoder": ["Conv_0", "mlp_encoder/Dense_0"],
    "sac_ae_decoder": ["fc", "mlp_decoder/Dense_0"],
    "sac_ae_actor": ["Dense_0"],
    "sac_ae_q": ["Dense_0"],
}


def _sac_family_entry(entry, precision="bf16-mixed"):
    """(port output, JAX output, port layers, JAX layers) of one SAC-family
    module, both packages at ``precision``, from the same weights; the
    stacked ensembles run under ``jax.vmap`` on the JAX side, their layer
    outputs stacked ``[n, B, ...]`` as the port's."""
    from sheeprl_tpu_torch.algos.sac.convert import StackedDense
    from tests import test_torch_droq, test_torch_sac, test_torch_sac_ae

    rng = np.random.default_rng(21)
    if entry.startswith("sac_ae"):
        cfg = test_torch_sac_ae.ae_cfg()
        cfg["fabric"]["precision"] = precision
        jag, tag, _ = test_torch_sac_ae.ae_pair(cfg)
        raw = test_torch_sac_ae._raw(4, 22)
        feat = np.asarray(jax.jit(jag.encoder.apply)(jag.encoder_params, test_torch_sac_ae._jax_obs(raw)), np.float32)
        act = rng.uniform(-2, 2, (4, 1)).astype(np.float32)
        calls = {
            "sac_ae_encoder": (tag.encoder, jag.encoder, jag.encoder_params, (test_torch_sac_ae._jax_obs(raw),), lambda: tag.encoder(tagent_ae.encoder_inputs({k: t(v) for k, v in raw.items()}, ("rgb",), ("state",)))),
            "sac_ae_decoder": (tag.decoder, jag.decoder, jag.decoder_params, (feat,), lambda: tag.decoder(t(feat))),
            "sac_ae_actor": (tag.actor, jag.actor, jag.actor_params, (feat,), lambda: tag.actor(t(feat))),
            "sac_ae_q": (tag.qf, jag.qf, jag.qfs_params, (feat, act), lambda: tag.qf(t(feat), t(act))),
        }
    else:
        droq = entry.startswith("droq")
        cfg = test_torch_droq.droq_cfg() if droq else test_torch_sac.sac_cfg()
        cfg["fabric"]["precision"] = precision
        jag, tag, _ = test_torch_droq._pair_at(cfg) if droq else test_torch_sac.jax_pair(cfg)
        obs = rng.standard_normal((6, 5)).astype(np.float32)
        act = rng.uniform(-2, 2, (6, 2)).astype(np.float32)
        calls = {
            "sac_actor": (tag.actor, jag.actor, jag.actor_params, (obs,), lambda: tag.actor(t(obs))),
            "sac_critics": (tag.critic, jag.critic, jag.critic_params, (obs, act), lambda: tag.critic(t(obs), t(act))),
            "droq_critics": (tag.critic, jag.critic, jag.critic_params, (obs, act), lambda: tag.critic(t(obs), t(act))),
        }
    tmod, jmod, params, args, port_fn = calls[entry]
    jfn = lambda p, *a: jmod.apply(p, *a, capture_intermediates=True, mutable=["intermediates"])  # noqa: E731
    if entry.endswith(("critics", "_q")):
        # the JAX ensemble: one module vmapped over stacked params
        jfn = jax.vmap(jfn, in_axes=(0,) + (None,) * len(args))
    want, inter = jax.jit(jfn)(params, *args)
    seen, hooks = {}, []
    for name, m in tmod.named_modules():
        if isinstance(m, PRODUCT_LAYERS + (StackedDense,)):
            path = name.replace(".", "/")
            hooks.append(m.register_forward_hook(lambda _m, _a, o, p=path: seen.setdefault(p, []).append(_nhwc(o))))
    try:
        with torch.no_grad():
            got = port_fn()
    finally:
        for h in hooks:
            h.remove()
    flat = lambda o: list(o.values()) if isinstance(o, dict) else list(o) if isinstance(o, (tuple, list)) else [o]  # noqa: E731
    if entry.endswith(("critics", "_q")):
        want = jnp.moveaxis(want[..., 0], 0, -1)
    jlayers = {p: v for p, v in _flax_layers(inter["intermediates"]).items() if p}
    return flat(got), flat(want), seen, jlayers


@pytest.mark.parametrize("entry", list(SAC_FAMILY))
def test_sac_family_product_layers_compute_as_flax_at_bf16(entry):
    """Every Dense, stacked Dense, conv and transposed conv of the SAC
    family outputs flax's dtype at bf16-mixed (the hidden products bf16, the
    heads fp32), the first products equal, the outputs within
    ``ENTRY_TOL``; in fp32 the same layers fail the check."""
    got, want, layers, jlayers = _sac_family_entry(entry)
    for g, w in zip(got, want):
        if entry == "sac_ae_decoder" and g.dim() == 4:
            g = g.permute(0, 2, 3, 1)
        assert same_dtype(g, w) and tuple(g.shape) == tuple(w.shape), (entry, g.dtype, w.dtype, g.shape, w.shape)
        assert rel_err(g, w) <= ENTRY_TOL, (entry, rel_err(g, w) / EPS)
    # the decoder's last deconvolution is flax's before the crop: its dtype only
    first = SAC_FAMILY[entry]
    mismatched = sorted(p for p in layers if not all(same_dtype(a, b) for a, b in zip(layers[p], jlayers[p])))
    assert set(layers) <= set(jlayers) and not mismatched, (sorted(set(layers) - set(jlayers)), mismatched)
    worst = max(rel_err(layers[p][0], jlayers[p][0]) for p in first)
    assert worst <= LAYER_TOL, worst / EPS
    _, _, layers32, _ = _sac_family_entry(entry, "32-true")
    assert any(not same_dtype(layers32[p][0], jlayers[p][0]) for p in first)
