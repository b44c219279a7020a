"""Procedural scenario variants over the torch twins (port of
``sheeprl_tpu/envs/variants.py:79-292``).

Each variant is a spec -> spec combinator parameterised by one column of a
scenario matrix ``theta [B, P]``: the port's twins step a batch of envs
with a leading env axis, so a ``[B]`` theta column makes every env a
distinct instance of one program (the JAX package vmaps
``family.instantiate`` over the rows). ``theta = 0`` is the identity of
every variant. A wrapper's state nests the inner state under ``"env"``
beside its own fields.

Variants, in the canonical order (physics innermost):

- ``phys_size`` / ``phys_speed`` / ``phys_mass``: the base dynamics rebuilt
  with that constant scaled by ``exp(theta)`` (``PHYSICS_FACTORIES``);
- ``sticky_actions``: the previous action repeated with probability
  ``theta``;
- ``reward_delay``: rewards emitted ``round(theta * max_delay)`` steps late
  through a ``[B, max_delay]`` ring, flushed at episode end;
- ``distractors``: ``dims`` AR(1) noise entries scaled by ``theta``
  appended to the observation.

Randomness: a step draws from the generator it is given, the wrapper's
draws before the inner env's (the JAX wrappers split the key and pass the
second half inward). The draws go through :func:`_uniform_noise` and
:func:`_normal_noise`, the one place the parity tests inject the JAX
package's samples; a torch generator never draws the JAX package's
threefry samples, so a scenario matrix from the same seed differs too.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.envs.jittable import PHYSICS_FACTORIES, JittableEnvSpec, StepOut, get_jittable_env

State = Dict[str, Any]

VARIANT_ORDER: Tuple[str, ...] = (
    "phys_size",
    "phys_speed",
    "phys_mass",
    "sticky_actions",
    "reward_delay",
    "distractors",
)

DEFAULT_RANGES: Dict[str, Tuple[float, float]] = {
    "phys_size": (-0.2, 0.2),
    "phys_speed": (-0.2, 0.2),
    "phys_mass": (-0.2, 0.2),
    "sticky_actions": (0.0, 0.3),
    "reward_delay": (0.0, 1.0),
    "distractors": (0.0, 1.0),
}

_DISTRACTOR_RHO = 0.9


def _uniform_noise(generator: Optional[torch.Generator], shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def _normal_noise(generator: Optional[torch.Generator], shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _leading(state: Any) -> torch.Tensor:
    """A leaf of a (nested) state, for its batch size and device."""
    while isinstance(state, dict):
        state = next(iter(state.values()))
    return state


def _column(theta: Any, device: torch.device) -> torch.Tensor:
    """``theta`` as a float32 tensor on ``device`` ([B] or scalar)."""
    return torch.as_tensor(theta, dtype=torch.float32, device=device)


def _physics_axis(axis: str) -> Callable[[JittableEnvSpec, Any], JittableEnvSpec]:
    def combinator(spec: JittableEnvSpec, theta: Any) -> JittableEnvSpec:
        factory = PHYSICS_FACTORIES.get(spec.env_id)
        if factory is None:
            raise ValueError(f"no physics factory registered for env id '{spec.env_id}'")
        factors: Dict[str, Any] = {"size": 1.0, "speed": 1.0, "mass": 1.0}
        factors[axis] = torch.exp(torch.as_tensor(theta, dtype=torch.float32))
        return factory(factors["size"], factors["speed"], factors["mass"])

    return combinator


def with_sticky_actions(spec: JittableEnvSpec, theta: Any) -> JittableEnvSpec:
    """Repeat the previous action with probability ``theta``."""

    def init(generator: torch.Generator, batch: int = 1) -> State:
        inner = spec.init(generator, batch)
        dev = _leading(inner).device
        if spec.is_continuous:
            prev = torch.zeros(batch, spec.action_dim, device=dev)
        else:
            prev = torch.zeros(batch, dtype=torch.int64, device=dev)
        return {"env": inner, "prev_a": prev, "has_prev": torch.zeros(batch, dtype=torch.bool, device=dev)}

    def step(state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[State, StepOut]:
        prev = state["prev_a"]
        dev = prev.device
        u = _uniform_noise(generator, (prev.shape[0],), dev)
        # strict < keeps theta=0 an exact identity (uniform is in [0, 1))
        use_prev = (u < _column(theta, dev)) & state["has_prev"]
        action = torch.as_tensor(action, device=dev).reshape(prev.shape).to(prev.dtype)
        mask = use_prev.reshape(use_prev.shape + (1,) * (prev.ndim - 1))
        eff = torch.where(mask, prev, action)
        inner_next, out = spec.step(state["env"], eff, generator)
        return {"env": inner_next, "prev_a": eff, "has_prev": torch.ones_like(state["has_prev"])}, out

    def observation(state: State) -> torch.Tensor:
        return spec.observation(state["env"])

    return spec._replace(init=init, step=step, observation=observation)


def with_reward_delay(spec: JittableEnvSpec, theta: Any, *, max_delay: int = 4) -> JittableEnvSpec:
    """Emit rewards ``round(theta * max_delay)`` steps late; the ring
    flushes into the terminal reward, so an episode's return is kept."""

    def init(generator: torch.Generator, batch: int = 1) -> State:
        inner = spec.init(generator, batch)
        return {"env": inner, "buf": torch.zeros(batch, max_delay, device=_leading(inner).device)}

    def step(state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[State, StepOut]:
        inner_next, out = spec.step(state["env"], action, generator)
        buf = state["buf"]  # buf[:, i] is emitted i+1 steps from now
        dev = buf.device
        k = torch.clamp(torch.round(_column(theta, dev) * max_delay).to(torch.int32), 0, max_delay)
        k = k.expand(buf.shape[0])
        emit_now = torch.where(k == 0, out.reward, buf[:, 0])
        shifted = torch.cat([buf[:, 1:], torch.zeros_like(buf[:, :1])], 1)
        slot = (torch.arange(max_delay, device=dev)[None] == (k - 1)[:, None]) & (k > 0)[:, None]
        new_buf = shifted + torch.where(slot, out.reward[:, None], torch.zeros_like(shifted))
        done = out.terminated | out.truncated
        emit = torch.where(done, emit_now + new_buf.sum(-1), emit_now)
        new_buf = torch.where(done[:, None], torch.zeros_like(new_buf), new_buf)
        return {"env": inner_next, "buf": new_buf}, out._replace(reward=emit)

    def observation(state: State) -> torch.Tensor:
        return spec.observation(state["env"])

    return spec._replace(init=init, step=step, observation=observation)


def with_distractors(spec: JittableEnvSpec, theta: Any, *, dims: int = 4) -> JittableEnvSpec:
    """Append ``dims`` AR(1) noise entries scaled by ``theta``."""

    def scale(dx: torch.Tensor) -> torch.Tensor:
        th = _column(theta, dx.device)
        return (th[:, None] if th.ndim == 1 else th) * dx

    def init(generator: torch.Generator, batch: int = 1) -> State:
        dx = _normal_noise(generator, (batch, dims), generator.device if generator is not None else torch.device("cpu"))
        return {"env": spec.init(generator, batch), "dx": dx}

    def step(state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[State, StepOut]:
        eps = _normal_noise(generator, tuple(state["dx"].shape), state["dx"].device)
        inner_next, out = spec.step(state["env"], action, generator)
        dx = _DISTRACTOR_RHO * state["dx"] + (1.0 - _DISTRACTOR_RHO**2) ** 0.5 * eps
        return {"env": inner_next, "dx": dx}, out._replace(obs=torch.cat([out.obs, scale(dx)], -1))

    def observation(state: State) -> torch.Tensor:
        return torch.cat([spec.observation(state["env"]), scale(state["dx"])], -1)

    return spec._replace(init=init, step=step, observation=observation, obs_dim=spec.obs_dim + dims)


VARIANTS: Dict[str, Callable[..., JittableEnvSpec]] = {
    "phys_size": _physics_axis("size"),
    "phys_speed": _physics_axis("speed"),
    "phys_mass": _physics_axis("mass"),
    "sticky_actions": with_sticky_actions,
    "reward_delay": with_reward_delay,
    "distractors": with_distractors,
}


class ScenarioFamily(NamedTuple):
    """A variant-wrapped env family: metadata and ``instantiate(theta [B,
    P]) -> spec`` of B envs."""

    env_id: str
    base_id: str
    variant_names: Tuple[str, ...]
    param_dim: int
    obs_dim: int
    is_continuous: bool
    action_dim: int
    max_episode_steps: int
    instantiate: Callable[[torch.Tensor], JittableEnvSpec]


def compose_variant_env_id(base_id: str, variant_names: Sequence[str]) -> str:
    """``base+variant1+variant2``."""
    return "+".join([base_id, *variant_names])


def parse_variant_env_id(env_id: str) -> Tuple[str, Tuple[str, ...]]:
    """Inverse of :func:`compose_variant_env_id`."""
    base, *names = env_id.split("+")
    return base, tuple(names)


def canonical_variant_order(variant_names: Sequence[str]) -> Tuple[str, ...]:
    """The requested variants in the canonical composition order."""
    unknown = sorted(set(variant_names) - set(VARIANT_ORDER))
    if unknown:
        raise ValueError(f"unknown variant(s) {unknown}; known: {list(VARIANT_ORDER)}")
    return tuple(name for name in VARIANT_ORDER if name in variant_names)


def make_scenario_family(
    base_id: str, variant_names: Sequence[str], *, distractor_dims: int = 4, reward_max_delay: int = 4
) -> Optional[ScenarioFamily]:
    """The family of ``variant_names`` over ``base_id``'s twin, or ``None``
    when it has no twin."""
    names = canonical_variant_order(variant_names)
    base = get_jittable_env(base_id)
    if base is None:
        return None
    if any(n.startswith("phys_") for n in names) and base_id not in PHYSICS_FACTORIES:
        raise ValueError(f"no physics factory registered for env id '{base_id}'")

    def instantiate(theta: torch.Tensor) -> JittableEnvSpec:
        spec = base
        for i, name in enumerate(names):
            col = theta[..., i]
            if name == "distractors":
                spec = with_distractors(spec, col, dims=distractor_dims)
            elif name == "reward_delay":
                spec = with_reward_delay(spec, col, max_delay=reward_max_delay)
            else:
                spec = VARIANTS[name](spec, col)
        return spec

    return ScenarioFamily(
        env_id=compose_variant_env_id(base_id, names),
        base_id=base_id,
        variant_names=names,
        param_dim=len(names),
        obs_dim=base.obs_dim + (distractor_dims if "distractors" in names else 0),
        is_continuous=base.is_continuous,
        action_dim=base.action_dim,
        max_episode_steps=base.max_episode_steps,
        instantiate=instantiate,
    )


def identity_theta(family: ScenarioFamily, batch: int = 1) -> torch.Tensor:
    """Theta rows at which every variant is a no-op."""
    return torch.zeros(batch, family.param_dim)


def sample_scenario_matrix(
    generator: torch.Generator,
    n: int,
    variant_names: Sequence[str],
    ranges: Optional[Dict[str, Tuple[float, float]]] = None,
) -> torch.Tensor:
    """A uniform ``[n, P]`` scenario matrix, one column a variant, in the
    canonical order; ``ranges`` overrides :data:`DEFAULT_RANGES`."""
    names = canonical_variant_order(variant_names)
    merged = dict(DEFAULT_RANGES)
    merged.update(ranges or {})
    cols = []
    for name in names:
        low, high = merged[name]
        u = _uniform_noise(generator, (n,), generator.device)
        cols.append(low + (high - low) * u)
    if not cols:
        return torch.zeros(n, 0, device=generator.device)
    return torch.stack(cols, 1)
