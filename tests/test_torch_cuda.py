"""The port's CUDA kernels (sheeprl_tpu_torch/csrc/fused_gru.cu) against
their plain PyTorch versions on the card, alone and inside the Dreamer-V3
train step (fused against plain, launches a step, determinism, the
continuous actor's gradient through the kernel's backward), and the train
step captured as a CUDA graph (sheeprl_tpu_torch/ops/graph.py: replays
against eager steps, fresh noise each replay, a capture refusing a host
sync, Adam's count and SGD's state on the device, a capture that keeps the
allocators' caches); the PPO, A2C and recurrent PPO updates
and fused rollouts captured against eager; the Plan2Explore exploration
step captured against eager, B1 launched in its scan and both
imaginations; a placed player's copy across the bus, PPO's update on a side
stream beside the player's snapshot, and Dreamer-V2's step captured
against eager.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports neither JAX nor the JAX package, so with ``--noconftest``
(tests/conftest.py imports the JAX package) it runs on a machine that has
the card and not the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Bounds: 1e-5 on the forward and 1e-4 on the gradients, all fp32 with sums
taken in another order (the JAX package's own bounds for its kernel,
tests/test_ops/test_pallas_gru.py). The projection's tensor-core route
(bf16 weights) keeps the forward's 1e-5: it splits the fp32 activations
into three bf16 planes, exact to fp32 (tests/test_torch_proj_split.py). The fused step also takes a
bf16 ``x`` (``bf16-mixed``), read and upcast inside the kernel: it keeps
the same bounds against ``reference_step`` on the same bf16 ``x``. The
train-step tests run at ``32-true`` unless they say otherwise; the
bf16-mixed step is held replayed against eager at the same 1e-6. The parity
of the plain versions with the JAX package is held on the CPU by
tests/test_torch_fused_gru.py, tests/test_torch_sharded_gru.py and
tests/test_torch_precision.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import fused_gru as tgru

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _np_args(seed, batch=5, in_dim=12, dense=16, hidden=8):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [
        n(batch, in_dim),
        n(batch, hidden),
        n(in_dim, dense) * 0.3,
        n(dense) * 0.1,
        1.0 + 0.1 * n(dense),
        0.1 * n(dense),
        n(hidden + dense, 3 * hidden) * 0.3,
        1.0 + 0.1 * n(3 * hidden),
        0.1 * n(3 * hidden),
    ]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernels and their launch plan have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# --------------------------------------------------------------------------- #
# fused_gru: the fused RSSM step
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize(
    "depth, cols, rows, want",
    [
        (1027, 512, 4, (33, 32)),  # S input projection, num_envs=4: 4 x 33 blocks
        (1024, 1536, 4, (16, 64)),  # S joint projection: 12 x 16 blocks
        (1024, 1536, 1024, (1, 1024)),  # many rows fill the card without a split
        (7, 3, 1, (1, 32)),  # shallower than one tile
    ],
)
def test_split_plan(cuda, depth, cols, rows, want):
    """The depth split that csrc/fused_gru.cu plans for splitk_matmul (the
    sharded projection's CUDA-core route) on a 132-SM card."""
    chunk = ctypes.c_int()
    splits = tgru.load_library().fused_gru_split_plan(depth, cols, rows, 132, ctypes.byref(chunk))
    assert (splits, chunk.value) == want
    assert chunk.value % 32 == 0 and (splits - 1) * chunk.value < depth <= splits * chunk.value


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch, want",
    [
        # rows a tile, row tiles, launch A's cluster and chunks of x @ W1 and
        # h @ W2[:H], launch B's cluster and chunk of feat @ W2[H:], blocks
        (1, (4, 1, 8, 160, 64, 8, 64, 128, 96)),  # 16 tiles x 8 splits, then 12 x 8
        (4, (4, 1, 8, 160, 64, 8, 64, 128, 96)),  # the S player
        (16, (8, 2, 8, 160, 64, 8, 64, 256, 192)),  # one observe step of 16 sequences: 2 row tiles
        (1024, (16, 64, 1, 1056, 512, 1, 512, 1024, 768)),  # imagination: 64 row tiles, no split
    ],
)
def test_step_plan(cuda, batch, want):
    """The tiles and depth splits of the fused step that csrc/fused_gru.cu
    plans at Dreamer-V3 S (X=1027, D=512, H=512) for a 132-SM card: the
    largest cluster of depth splits (up to 8) with which all of a launch's
    blocks fit two an SM, each split whole 32-deep steps."""
    plan = tgru.step_plan(batch, 1027, 512, 512, sm_count=132)
    assert tuple(plan[k] for k in tgru.STEP_PLAN_FIELDS) == want
    assert plan["blocks_a"] <= 2 * 132 or plan["cluster_a"] == 1
    assert plan["blocks_b"] <= 2 * 132 or plan["cluster_b"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch, in_dim, dense, hidden",
    [
        (1, 1027, 512, 512),
        (4, 1027, 512, 512),
        (33, 70, 40, 24),
        (16, 1027, 512, 512),
        (1024, 1027, 512, 512),  # S at the imagination batch
        (4, 1027, 640, 1024),  # M
        (1, 1027, 42, 25),  # D and 3H not multiples of 4: masked scalar weight loads
        (17, 1027, 42, 25),  # a ragged row tile
        (1000, 1027, 42, 25),
        (5, 37, 42, 25),  # depths shorter than a cluster's 8 splits: ranks with no depth rows
    ],
)
def test_cuda_kernel_matches_plain(cuda, batch, in_dim, dense, hidden):
    args = [torch.tensor(a, device=cuda) for a in _np_args(6, batch, in_dim, dense, hidden)]
    before = tgru.launch_count
    got = tgru.fused_recurrent_step(*args)
    torch.cuda.synchronize()
    assert tgru.launch_count == before + 1
    torch.testing.assert_close(got, tgru.reference_step(*args), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.cuda
def test_cuda_kernel_unaligned_weights(cuda):
    """Weights 4 bytes off a 16-byte boundary take the masked scalar loads."""
    args = [torch.tensor(a, device=cuda) for a in _np_args(8, 4, 1027, 512, 512)]
    for i in (2, 6):  # w1, w2
        buf = torch.empty(args[i].numel() + 1, device=cuda)
        args[i] = buf[1:].view(args[i].shape).copy_(args[i])
    got = tgru.launch(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tgru.reference_step(*args), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 1024])
def test_cuda_kernel_deterministic(cuda, batch):
    """No atomics in a sum, only counters: two calls give the same bits."""
    args = [torch.tensor(a, device=cuda) for a in _np_args(9, batch, 1027, 512, 512)]
    assert torch.equal(tgru.launch(*args), tgru.launch(*args))


@pytest.mark.cuda
def test_cuda_kernel_captures_into_a_graph(cuda):
    """Both launches, the second a programmatic dependent launch with a
    cluster, replay from a CUDA graph."""
    args = [torch.tensor(a, device=cuda) for a in _np_args(10, 4, 1027, 512, 512)]
    eager = tgru.launch(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tgru.launch(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tgru.launch(*args)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_cuda_kernel_gradients_match_plain(cuda):
    args = _np_args(7)
    leaves = [torch.tensor(a, device=cuda, requires_grad=True) for a in args]
    ref = [torch.tensor(a, device=cuda, requires_grad=True) for a in args]
    tgru.fused_recurrent_step(*leaves).square().sum().backward()
    tgru.reference_step(*ref).square().sum().backward()
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch, in_dim, dense, hidden",
    [
        (4, 1027, 512, 512),  # the S player at bf16-mixed
        (16, 1027, 512, 512),  # the scan
        (1024, 1027, 512, 512),  # imagination
        (17, 1027, 42, 25),  # a ragged row tile, masked weight loads
        (5, 37, 42, 25),  # ranks with no depth rows
    ],
)
def test_cuda_kernel_takes_bf16_x(cuda, batch, in_dim, dense, hidden):
    """A bf16 x is read and upcast inside launch A (no cast launch before
    it): the forward against reference_step on the same bf16 x, the
    gradients against autograd through it, dx in bf16."""
    args = [torch.tensor(a, device=cuda) for a in _np_args(11, batch, in_dim, dense, hidden)]
    x32 = args[0]
    args[0] = x32.bfloat16()
    before, before_bf16 = tgru.launch_count, tgru.bf16_x_launch_count
    got = tgru.launch(*args)
    torch.cuda.synchronize()
    assert (tgru.launch_count, tgru.bf16_x_launch_count) == (before + 1, before_bf16 + 1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, tgru.reference_step(*args), atol=FWD_TOL, rtol=FWD_TOL)
    assert not torch.equal(got, tgru.launch(x32, *args[1:]))  # the step sees the rounded x
    leaves = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    tgru.fused_recurrent_step(*leaves).square().sum().backward()
    tgru.reference_step(*ref).square().sum().backward()
    assert leaves[0].grad.dtype == torch.bfloat16
    # dx is an fp32 gradient rounded to bf16: the two sums may round a
    # value to neighbouring bf16 numbers, one ulp (2^-7 relative) apart
    torch.testing.assert_close(leaves[0].grad.float(), ref[0].grad.float(), atol=GRAD_TOL, rtol=2**-7)
    for a, b in zip(leaves[1:], ref[1:]):
        torch.testing.assert_close(a.grad, b.grad, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("index, dtype", [(1, torch.bfloat16), (0, torch.float16), (2, torch.bfloat16), (6, torch.bfloat16)])
def test_cuda_kernel_takes_only_x_in_bf16(cuda, index, dtype):
    """h, the weights and the norms stay fp32; x is fp32 or bf16."""
    args = [torch.tensor(a, device=cuda) for a in _np_args(12, 4, 1027, 512, 512)]
    args[index] = args[index].to(dtype)
    with pytest.raises(TypeError):
        tgru.launch(*args)
    with pytest.raises(TypeError):
        tgru.fused_recurrent_step(*args)


# --------------------------------------------------------------------------- #
# sharded_proj: one rank's projection of the model-sharded step
# --------------------------------------------------------------------------- #


def _proj_inputs(device, batch, w2_dtype, hidden=2048, dense=768, cols=1536):
    """One rank's operands at the L / 4-way shapes: h a GRU state in (-1, 1),
    feat a SiLU output."""
    gen = torch.Generator(device=device).manual_seed(batch)
    h = torch.randn(batch, hidden, device=device, generator=gen).tanh()
    feat = torch.nn.functional.silu(torch.randn(batch, dense, device=device, generator=gen))
    w2s = (torch.randn(hidden + dense, cols, device=device, generator=gen) * (hidden + dense) ** -0.5).to(w2_dtype)
    return h, feat, w2s


@pytest.mark.cuda
@pytest.mark.parametrize("w2_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 16, 1024])
def test_cuda_projection_matches_plain(cuda, batch, w2_dtype):
    h, feat, w2s = _proj_inputs(cuda, batch, w2_dtype)
    before = tgru.proj_launch_count
    got = tgru.sharded_proj(h, feat, w2s)
    torch.cuda.synchronize()
    assert tgru.proj_launch_count == before + 1
    torch.testing.assert_close(got, tgru.proj_reference(h, feat, w2s), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("w2_dtype", [torch.float32, torch.bfloat16])
def test_cuda_projection_gradients_match_plain(cuda, w2_dtype):
    inputs = _proj_inputs(cuda, 16, w2_dtype, hidden=64, dense=32, cols=48)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    ref = [t.clone().requires_grad_(True) for t in inputs]
    cot = torch.randn(16, 48, device=cuda)
    tgru.sharded_proj(*leaves).backward(cot)
    tgru.proj_reference(*ref).backward(cot)
    for a, b in zip(leaves, ref):
        assert a.grad.dtype == a.dtype
        tol = GRAD_TOL if a.dtype == torch.float32 else 8e-3  # dW2 stored in bf16: 2 ulps
        torch.testing.assert_close(a.grad.float(), b.grad.float(), atol=GRAD_TOL, rtol=tol)


# --------------------------------------------------------------------------- #
# sharded_proj's tensor-core route (bf16 weights, C % 8 == 0, 16-byte aligned)
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch, hidden, dense, cols",
    [
        (1, 2048, 792, 48),  # depth 2840, not a multiple of the 32-deep tile
        (17, 2048, 792, 776),  # ragged batch and columns
        (1000, 2048, 792, 776),
        (16, 2048, 768, 1536),  # L / 4-way
        (64, 2048, 768, 1536),  # the first batch of the 64-row tile
        (1024, 2048, 768, 1536),  # L / 4-way, imagination batch
        (1024, 4096, 1024, 768),  # XL / 16-way, imagination batch
        (16, 4096, 1024, 12288),  # XL / 1-way, a 126 MB slice
    ],
)
def test_cuda_projection_tensor_cores_match_plain(cuda, batch, hidden, dense, cols):
    h, feat, w2s = _proj_inputs(cuda, batch, torch.bfloat16, hidden, dense, cols)
    assert tgru.proj_plan(h, feat, w2s)[0] == ("tc64" if batch >= 64 else "tc16")
    before = (tgru.proj_launch_count, tgru.proj_tc_launch_count)
    got = tgru.sharded_proj(h, feat, w2s)
    torch.cuda.synchronize()
    assert (tgru.proj_launch_count, tgru.proj_tc_launch_count) == (before[0] + 1, before[1] + 1)
    assert got.shape == (batch, cols) and torch.isfinite(got).all()
    assert (got - tgru.proj_reference(h, feat, w2s)).abs().max().item() <= FWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, dense, cols", [(2048, 768, 1536), (4096, 1024, 768)])
def test_cuda_projection_tensor_cores_deterministic(cuda, hidden, dense, cols):
    """No atomics: two calls at the imagination batch give the same bits."""
    h, feat, w2s = _proj_inputs(cuda, 1024, torch.bfloat16, hidden, dense, cols)
    assert torch.equal(tgru.proj_launch(h, feat, w2s), tgru.proj_launch(h, feat, w2s))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "w2_dtype, cols, offset, route",
    [
        (torch.bfloat16, 48, 0, "tc16"),
        (torch.float32, 48, 0, "splitk"),  # fp32 weights keep the CUDA-core kernel
        (torch.bfloat16, 50, 0, "splitk"),  # C % 8 != 0: no 16-byte copies of a row
        (torch.bfloat16, 48, 1, "splitk"),  # W2s 2 bytes off a 16-byte boundary
    ],
)
def test_cuda_projection_route(cuda, w2_dtype, cols, offset, route):
    h, feat, w2s = _proj_inputs(cuda, 16, w2_dtype, hidden=64, dense=32, cols=cols)
    if offset:
        buf = torch.empty(w2s.numel() + offset, dtype=w2_dtype, device=cuda)
        w2s = buf[offset:].view(w2s.shape).copy_(w2s)
    assert tgru.proj_plan(h, feat, w2s)[0] == route
    before = (tgru.proj_launch_count, tgru.proj_tc_launch_count)
    got = tgru.proj_launch(h, feat, w2s)
    torch.cuda.synchronize()
    assert (tgru.proj_launch_count, tgru.proj_tc_launch_count) == (before[0] + 1, before[1] + (route != "splitk"))
    assert (got - tgru.proj_reference(h, feat, w2s)).abs().max().item() <= FWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch, hidden, dense, cols, w2_dtype, want",
    [
        (4, 512, 512, 1536, torch.float32, ("splitk", 16, 64)),  # S joint projection, as test_split_plan
        (16, 2048, 768, 1536, torch.bfloat16, ("tc16", 22, 128)),  # chunks no shorter than the ring
        (16, 4096, 1024, 12288, torch.bfloat16, ("tc16", 5, 1024)),  # 96 x 5 blocks, 4 an SM
        (1024, 2048, 768, 1536, torch.bfloat16, ("tc64", 1, 2816)),  # 192 blocks: no split
        (1024, 4096, 1024, 768, torch.bfloat16, ("tc64", 2, 2560)),  # 96 x 2 blocks, 2 an SM
    ],
)
def test_cuda_projection_plan(cuda, batch, hidden, dense, cols, w2_dtype, want):
    """The route and depth split csrc/fused_gru.cu plans for a 132-SM card."""
    h = torch.empty(batch, hidden, device=cuda)
    feat = torch.empty(batch, dense, device=cuda)
    w2s = torch.empty(hidden + dense, cols, dtype=w2_dtype, device=cuda)
    route, splits, chunk, floats = tgru.proj_plan(h, feat, w2s, sm_count=132)
    assert (route, splits, chunk) == want
    assert floats == (splits * batch * cols if splits > 1 else 0)


# --------------------------------------------------------------------------- #
# the Dreamer-V3 train step through fused_gru
# --------------------------------------------------------------------------- #

# the fused and plain train steps on the same weights and batch: each metric
# within TRAIN_BOUND of the plain one relative to max(|plain|, 1), each
# gradient tensor within TRAIN_BOUND relative to its largest element (the
# kernel's 1e-6-level differences carried through the scan and its backward)
TRAIN_BOUND = 1e-3
SMALL_TRAIN = {
    "algo.dense_units": 64,
    "algo.mlp_layers": 1,
    "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 64,
    "algo.world_model.transition_model.hidden_size": 32,
    "algo.world_model.representation_model.hidden_size": 32,
    "algo.world_model.stochastic_size": 8,
    "algo.world_model.discrete_size": 8,
    "env.screen_size": 16,
}


@pytest.fixture()
def smooth():
    """Deterministic samplers (probabilities straight through, a normal
    head's location), so fused and plain steps see the same noise: the ones
    chip_smoke.py's training phase uses."""
    import chip_smoke

    with chip_smoke.deterministic():
        yield


def _train(continuous, fused, horizon, states=None, precision="32-true"):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, build_critic
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers, make_train_step
    from sheeprl_tpu_torch.configs import compose
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose(
        "XS",
        env="dummy_continuous" if continuous else "dummy_discrete",
        overrides={
            **SMALL_TRAIN,
            "fabric.precision": precision,
            "seed": 3,
            "algo.horizon": horizon,
            "algo.mlp_keys.encoder": ["state"],
            "algo.world_model.recurrent_model.fused": fused,
        },
    )
    space = spaces.Dict(
        {"rgb": spaces.Box(0, 255, (16, 16, 3), np.uint8), "state": spaces.Box(-20, 20, (5,), np.float32)}
    )
    dims = (2,) if continuous else (3,)
    states = states or {}
    wm, actor, _ = build_agent(dims, continuous, cfg, space, states.get("wm"), states.get("actor"), device="cuda")
    critic, target = build_critic(cfg, wm.latent_state_size, states.get("critic"), states.get("target"), "cuda")
    opts = build_optimizers(cfg, wm, actor, critic)
    step = make_train_step(wm, actor, critic, target, *opts, cfg, continuous)
    models = {"wm": wm, "actor": actor, "critic": critic, "target": target}
    return models, step, opts


def _batch(T, B, continuous, seed=0):
    rng = np.random.default_rng(seed)
    d = {
        "rgb": rng.integers(0, 256, (T, B, 16, 16, 3)).astype(np.uint8),
        "state": rng.standard_normal((T, B, 5)).astype(np.float32),
        "actions": (
            rng.uniform(-1, 1, (T, B, 2)) if continuous else np.eye(3)[rng.integers(0, 3, (T, B))]
        ).astype(np.float32),
        "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(T, B, 1)) < 0.05).astype(np.float32),
        "is_first": (rng.uniform(size=(T, B, 1)) < 0.05).astype(np.float32),
    }
    return {k: torch.from_numpy(v).cuda() for k, v in d.items()}


def _step(step, batch, grads=None):
    from sheeprl_tpu_torch.ops.math import init_moments

    tgru.reset_launch_count()
    moments, metrics = step(init_moments(torch.device("cuda")), batch, None, grads)
    torch.cuda.synchronize()
    return metrics, tgru.launch_count, moments


def _snapshot(models):
    return {k: {n: v.detach().clone() for n, v in m.state_dict().items()} for k, m in models.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("continuous", [False, True])
def test_cuda_train_step_fused_matches_plain(cuda, smooth, continuous):
    """One gradient step with the kernel against the plain recurrent model
    (fused: flax) from the same weights; continuous actions carry the actor's
    gradient through imagination and the kernel's backward."""
    fused, step, _ = _train(continuous, "auto", 4)
    plain, plain_step, _ = _train(continuous, "flax", 4, _snapshot(fused))
    assert fused["wm"].fused and not plain["wm"].fused
    batch = _batch(8, 4, continuous)
    g_f, g_p = {}, {}
    m_f, launches, mo_f = _step(step, batch, g_f)
    m_p, plain_launches, mo_p = _step(plain_step, batch, g_p)
    assert (launches, plain_launches) == (8 + 5, 0)
    assert torch.isfinite(m_f).all()
    assert ((m_f - m_p).abs() / m_p.abs().clamp_min(1.0)).max() <= TRAIN_BOUND
    for name in ("world_model", "actor", "critic"):
        for a, b in zip(g_f[name], g_p[name]):
            assert (a - b).abs().max() <= TRAIN_BOUND * b.abs().max().clamp_min(1e-30), name
    for k in ("wm", "actor", "critic"):
        for (n, a), b in zip(fused[k].state_dict().items(), plain[k].state_dict().values()):
            assert torch.allclose(a, b, atol=TRAIN_BOUND, rtol=TRAIN_BOUND), f"{k}.{n}"
    torch.testing.assert_close(mo_f.low, mo_p.low, atol=TRAIN_BOUND, rtol=TRAIN_BOUND)


@pytest.mark.cuda
def test_cuda_train_step_launches_the_kernel_once_a_recurrent_step(cuda):
    """T = 64 scan steps at B = 16 and horizon + 1 = 16 imagination steps at
    B = 1024: 80 launches a gradient step, none in the backward."""
    _, step, _ = _train(False, "auto", 15)
    _, launches, _ = _step(step, _batch(64, 16, False))
    assert launches == 64 + 16


@pytest.mark.cuda
def test_cuda_train_step_is_deterministic(cuda, monkeypatch):
    """Two gradient steps from the same state, batch and generator seed give
    the same bits: metrics and every updated parameter. cuDNN's default
    weight-gradient algorithms for the convolutions sum in a run-dependent
    order, so the test asks cuDNN for its deterministic ones."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    first, step, _ = _train(False, "auto", 4)
    states = _snapshot(first)
    second, step2, _ = _train(False, "auto", 4, states)
    batch = _batch(8, 4, False)
    gen = [torch.Generator(device="cuda").manual_seed(7) for _ in range(2)]
    from sheeprl_tpu_torch.ops.math import init_moments

    out = [s(init_moments(torch.device("cuda")), batch, g)[1] for s, g in zip((step, step2), gen)]
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])
    for k in ("wm", "actor", "critic"):
        for a, b in zip(first[k].parameters(), second[k].parameters()):
            assert torch.equal(a, b), k


@pytest.mark.cuda
def test_cuda_continuous_actor_gradient_runs_the_kernel_backward_at_b1024(cuda, smooth, monkeypatch):
    """With continuous actions the policy loss is the advantage itself: its
    gradient reaches the actor through 16 imagination steps of the kernel at
    B = 16 x 64 = 1024 and their backward (the plain recompute)."""
    calls = []
    orig = tgru._FusedStep.backward

    def backward(ctx, grad):
        calls.append(grad.shape[0])
        return orig(ctx, grad)

    monkeypatch.setattr(tgru._FusedStep, "backward", staticmethod(backward))
    fused, step, _ = _train(True, "auto", 15)
    plain, plain_step, _ = _train(True, "flax", 15, _snapshot(fused))
    batch = _batch(64, 16, True)
    g_f, g_p = {}, {}
    m_f, launches, _ = _step(step, batch, g_f)
    _step(plain_step, batch, g_p)
    assert launches == 64 + 16
    # the last imagination step's successor is not kept: 15 backward calls
    assert calls.count(1024) == 15 and calls.count(16) == 64
    assert float(m_f[11]) > 0  # Grads/actor
    for a, b in zip(g_f["actor"], g_p["actor"]):
        assert (a - b).abs().max() <= TRAIN_BOUND * b.abs().max().clamp_min(1e-30)


# --------------------------------------------------------------------------- #
# the captured train step (ops/graph.py) and Adam's device state
# --------------------------------------------------------------------------- #

# replayed against eager steps from the same weights, batches and cuDNN's
# deterministic algorithms: each metric relative to max(|eager|, 1), each
# parameter relative to its tensor's largest element (the same kernels run
# in both; a graph only removes the host)
REPLAY_BOUND = 1e-6


def _captured(models, step, opts, batch, generator=None):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_fn
    from sheeprl_tpu_torch.ops.math import init_moments

    moments = init_moments(torch.device("cuda"))
    inputs = {k: torch.empty_like(v) for k, v in batch.items()}
    fn = make_train_fn(step, models["wm"], models["actor"], models["critic"], opts, moments, inputs, generator)
    return fn, moments


@pytest.mark.cuda
@pytest.mark.parametrize("continuous", [False, True])
def test_cuda_replayed_steps_match_eager_steps(cuda, smooth, monkeypatch, continuous):
    """Three graph replays of the train step (fused kernel inside, its
    backward and the three Adam updates) against three eager steps on the
    same weights and batches: metrics, every parameter, Adam's count and
    the Moments."""
    from sheeprl_tpu_torch.ops.math import init_moments

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    graphed, gstep, gopts = _train(continuous, "auto", 4)
    eager, estep, eopts = _train(continuous, "auto", 4, _snapshot(graphed))
    batches = [_batch(8, 4, continuous, seed=s) for s in range(3)]
    fn, gmoments = _captured(graphed, gstep, gopts, batches[0])
    emoments = init_moments(torch.device("cuda"))
    for b in batches:
        for k, v in b.items():
            fn.inputs[k].copy_(v)
        got = fn()
        _, want = estep(emoments, b, None)
        assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= REPLAY_BOUND
    assert fn.replays == 3 and fn.captured_launches == 8 + 5
    for k in ("wm", "actor", "critic"):
        for a, b in zip(graphed[k].parameters(), eager[k].parameters()):
            assert (a - b).abs().max() <= REPLAY_BOUND * b.abs().max().clamp_min(1e-30), k
    assert [int(o.count) for o in gopts] == [int(o.count) for o in eopts] == [3, 3, 3]
    torch.testing.assert_close(gmoments.low, emoments.low, atol=REPLAY_BOUND, rtol=REPLAY_BOUND)


@pytest.mark.cuda
@pytest.mark.parametrize("continuous", [False, True])
def test_cuda_bf16_mixed_replayed_steps_match_eager_steps(cuda, smooth, monkeypatch, continuous):
    """The train step at bf16-mixed, the fused step reading a bf16 x inside
    it: three graph replays against three eager steps at the same bound as
    fp32 (the same kernels run in both)."""
    from sheeprl_tpu_torch.ops.math import init_moments

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    graphed, gstep, gopts = _train(continuous, "auto", 4, precision="bf16-mixed")
    eager, estep, eopts = _train(continuous, "auto", 4, _snapshot(graphed), precision="bf16-mixed")
    assert graphed["wm"].dtype == torch.bfloat16
    batches = [_batch(8, 4, continuous, seed=s) for s in range(3)]
    fn, gmoments = _captured(graphed, gstep, gopts, batches[0])
    emoments = init_moments(torch.device("cuda"))
    tgru.reset_launch_count()
    for b in batches:
        for k, v in b.items():
            fn.inputs[k].copy_(v)
        got = fn()
        _, want = estep(emoments, b, None)
        assert torch.isfinite(got).all()
        assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= REPLAY_BOUND
    assert fn.captured_launches == 8 + 5
    # every wrapper call (warm-up, capture, the eager steps) read a bf16 x
    assert tgru.bf16_x_launch_count == tgru.launch_count > 0
    for k in ("wm", "actor", "critic"):
        for a, b in zip(graphed[k].parameters(), eager[k].parameters()):
            assert a.dtype == torch.float32
            assert (a - b).abs().max() <= REPLAY_BOUND * b.abs().max().clamp_min(1e-30), k
    torch.testing.assert_close(gmoments.low, emoments.low, atol=REPLAY_BOUND, rtol=REPLAY_BOUND)


@pytest.mark.cuda
def test_cuda_replays_draw_fresh_noise_from_the_registered_generator(cuda):
    """The train generator is registered with the graph: two replays from
    the same state draw different noise, and re-setting the generator's
    state reproduces a replay's draw."""
    from sheeprl_tpu_torch.ops.graph import CapturedStep

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.zeros(64, device="cuda")
    fn = CapturedStep(lambda d: d["x"] + torch.rand(64, device="cuda", generator=gen), {"x": x}, [], gen)
    saved = gen.get_state()
    first, second = fn(), fn()
    assert not torch.equal(first, second)
    gen.set_state(saved)
    assert torch.equal(fn(), first)


@pytest.mark.cuda
def test_cuda_capture_refuses_a_host_sync(cuda):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, and nothing runs the step eagerly instead."""
    from sheeprl_tpu_torch.ops.graph import CapturedStep

    x = torch.ones(8, device="cuda")
    fn = CapturedStep(lambda d: d["x"] * float(d["x"].sum().item()), {"x": x}, [])
    with pytest.raises(RuntimeError):
        fn()
    assert fn.graph is None and fn.replays == 0


@pytest.mark.cuda
@pytest.mark.parametrize("release", [False, True])
def test_cuda_a_capture_keeps_the_allocators_caches(cuda, release):
    """A serving capture (``release_caches=False``) releases neither
    allocator's cache (in a serving pause, ``torch.cuda.graph``'s release
    took 0.15-0.36 s); a training capture (the default) goes through
    ``torch.cuda.graph``. Either way the replay is right and its parts are
    timed, the warm-up before them."""
    from sheeprl_tpu_torch.ops.graph import CapturedStep

    cached = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(16 << 20, dtype=torch.uint8, pin_memory=True)
    del cached, pinned
    reserved = torch.cuda.memory_reserved()
    x = torch.ones(8, device="cuda")
    fn = CapturedStep(lambda d: d["x"] * 2.0, {"x": x}, [], release_caches=release)
    fn.warm()
    out = fn()
    assert torch.equal(out, torch.full((8,), 2.0, device="cuda")) and fn.replays == 1
    if not release:
        assert torch.cuda.memory_reserved() >= reserved
    assert set(fn.capture_parts) == {"warmup_s", "enter_s", "capture_s", "instantiate_s"}


@pytest.mark.cuda
def test_cuda_sgd_state_lives_on_the_device(cuda):
    """SGD's trace and count are updated in place on the card: three
    replays of a captured step (momentum, Nesterov, a schedule) give the
    parameters of three eager steps."""
    from sheeprl_tpu_torch.ops.graph import CapturedStep
    from sheeprl_tpu_torch.ops.optim import SGD

    rng = np.random.default_rng(5)
    init = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32)).cuda() for a in init]
    params = [[torch.nn.Parameter(torch.from_numpy(a.copy()).cuda()) for a in init] for _ in range(2)]
    opts = [SGD(p, lr=1e-2, momentum=0.9, nesterov=True, weight_decay=0.01, max_grad_norm=0.5, schedule_steps=8) for p in params]
    inputs = {f"g{i}": g for i, g in enumerate(grads)}
    fn = CapturedStep(lambda d: opts[0].step(list(d.values())), inputs, [*params[0], *opts[0].state_tensors()])
    for _ in range(3):
        fn()
        opts[1].step(grads)
    assert int(opts[0].count) == int(opts[1].count) == 3
    for a, b in zip(params[0] + opts[0].trace, params[1] + opts[1].trace):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_cuda_adam_count_lives_on_the_device(cuda):
    """Adam's count is an int32 tensor on the card and its bias corrections
    are computed there: three replays of a captured step advance it to 3 and
    give the parameters of three eager steps."""
    from sheeprl_tpu_torch.ops.graph import CapturedStep
    from sheeprl_tpu_torch.ops.optim import Adam

    rng = np.random.default_rng(4)
    init = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32)).cuda() for a in init]
    params = [[torch.nn.Parameter(torch.from_numpy(a.copy()).cuda()) for a in init] for _ in range(2)]
    opts = [Adam(p, lr=1e-2, eps=1e-5, max_grad_norm=0.5) for p in params]
    assert opts[0].count.device.type == "cuda" and opts[0].count.dtype == torch.int32
    inputs = {f"g{i}": g for i, g in enumerate(grads)}
    fn = CapturedStep(lambda d: opts[0].step(list(d.values())), inputs, [*params[0], *opts[0].mu, *opts[0].nu, opts[0].count])
    for _ in range(3):
        fn()
        opts[1].step(grads)
    assert int(opts[0].count) == int(opts[1].count) == 3
    for a, b in zip(params[0], params[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------- #
# the device ring (data/device_buffer.py) and fused supersteps (ops/superstep.py)
# --------------------------------------------------------------------------- #


def _ring_steps(rng, n):
    return {
        "rgb": rng.integers(0, 256, (1, n, 16, 16, 3), dtype=np.uint8),
        "state": rng.standard_normal((1, n, 5)).astype(np.float32),
        "actions": np.eye(3, dtype=np.float32)[rng.integers(0, 3, (1, n))],
        "rewards": rng.standard_normal((1, n, 1)).astype(np.float32),
        "terminated": np.zeros((1, n, 1), np.float32),
        "truncated": np.zeros((1, n, 1), np.float32),
        "is_first": np.zeros((1, n, 1), np.float32),
    }


def _fed_ring_and_host(capacity=12, n_envs=3, steps=17):
    """A ring on the card and a host buffer fed the same steps, with a
    lone-env add every third step."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer

    ring = DeviceReplayBuffer(capacity, n_envs=n_envs, obs_keys=("rgb", "state"), device="cuda", seed=2)
    host = EnvIndependentReplayBuffer(
        capacity, n_envs=n_envs, obs_keys=("rgb", "state"), buffer_cls=SequentialReplayBuffer, seed=2
    )
    rng = np.random.default_rng(0)
    for i in range(steps):
        data = _ring_steps(rng, n_envs)
        ring.add(data)
        host.add(data)
        if i % 3 == 1:
            extra = _ring_steps(rng, 1)
            ring.add(extra, [i % n_envs])
            host.add(extra, [i % n_envs])
    return ring, host


@pytest.mark.cuda
def test_cuda_ring_gather_matches_the_host_buffer(cuda):
    """Windows drawn on the host and gathered on the card equal the host
    buffer's numpy gather of the same steps, bit for bit, into fresh tensors
    and into static inputs."""
    ring, host = _fed_ring_and_host()
    assert ring._pos.tolist() == [b._pos for b in host.buffer]
    T, B = 4, 8
    out = {k: torch.empty((T, B, *v.shape[2:]), dtype=v.dtype, device="cuda") for k, v in ring.bufs.items()}
    for into in (None, out):
        env_idx, starts = ring.draw_indices(B, T)
        got = ring.gather(env_idx, starts, T, into)
        rows = (starts[:, None] + np.arange(T)) % ring.buffer_size
        for k, v in got.items():
            assert v.device.type == "cuda"
            want = np.stack([np.asarray(host.buffer[e].buffer[k])[r, 0] for e, r in zip(env_idx, rows)], axis=1)
            np.testing.assert_array_equal(v.cpu().numpy(), want.astype(v.cpu().numpy().dtype), err_msg=k)


@pytest.mark.cuda
def test_cuda_ring_draw_in_a_graph(cuda):
    """The in-graph draw captured with its generator registered: each replay
    draws fresh windows, every one a start the host allows, and re-setting
    the generator reproduces a replay."""
    from sheeprl_tpu_torch.data.device_buffer import draw_from_mask, sequence_start_mask
    from sheeprl_tpu_torch.ops.graph import CapturedStep

    ring, _ = _fed_ring_and_host()
    _, pos, full = ring.superstep_inputs(4)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def draw(d):
        return draw_from_mask(gen, sequence_start_mask(d["pos"], d["full"], ring.buffer_size, 4), 256)

    fn = CapturedStep(draw, {"pos": pos, "full": full}, [], gen)
    saved = gen.get_state()
    first, second = fn(), fn()
    assert not torch.equal(first[1], second[1])
    for env_idx, starts in (first, second):
        for e, s in zip(env_idx.tolist(), starts.tolist()):
            assert s in set(ring._valid_starts(e, 4).tolist())
    gen.set_state(saved)
    assert all(torch.equal(a, b) for a, b in zip(fn(), first))


@pytest.mark.cuda
def test_cuda_auto_picks_the_ring_on_the_card(cuda):
    """buffer.device=auto at the Atari-100k shape (configs/exp/dreamer_v3_100k_*.yaml:
    buffer.size 100000, 1 env, 64x64x3): the ring, on the card, its bytes
    within 1% of the estimate; false keeps the host buffer."""
    from sheeprl_tpu_torch.configs import compose
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer, estimate_ring_bytes, make_sequential_replay
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose("S", overrides={"buffer.size": 100000, "env.num_envs": 1})
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    ring = make_sequential_replay(cfg, "cuda", space, (9,), 100000, 1, ["rgb"], None, 0)
    assert isinstance(ring, DeviceReplayBuffer) and ring.device.type == "cuda"
    step = {"rgb": np.zeros((1, 1, 64, 64, 3), np.uint8), "actions": np.zeros((1, 1, 9), np.float32)}
    step.update({k: np.zeros((1, 1, 1), np.float32) for k in ("rewards", "terminated", "truncated", "is_first")})
    ring.add(step)
    est = estimate_ring_bytes(space, (9,), 100000, 1)
    assert abs(ring.ring_bytes() - est) <= 0.01 * est
    del ring
    off = compose("S", overrides={"buffer.size": 100000, "env.num_envs": 1, "buffer.device": False, "buffer.memmap": False})
    assert isinstance(make_sequential_replay(off, "cuda", space, (9,), 100000, 1, ["rgb"], None, 0), EnvIndependentReplayBuffer)


@pytest.mark.cuda
def test_cuda_superstep_matches_two_replays(cuda, monkeypatch):
    """A K = 2 superstep graph over two pregathered batches against two
    replays of the per-step graph with the host EMA between them, from the
    same weights and train generator (the real samplers): metrics,
    parameters, target critic and Adam's state within REPLAY_BOUND."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import ema_, make_fused_train_fn
    from sheeprl_tpu_torch.ops.math import init_moments
    from sheeprl_tpu_torch.ops.superstep import pregathered

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    single, sstep, sopts = _train(False, "auto", 4)
    fused, fstep, fopts = _train(False, "auto", 4, _snapshot(single))
    batches = [_batch(8, 4, False, seed=s) for s in range(2)]
    sgen, fgen = (torch.Generator(device="cuda").manual_seed(9) for _ in range(2))
    fn, smoments = _captured(single, sstep, sopts, batches[0], sgen)
    want = []
    for i, b in enumerate(batches):
        ema_(single["critic"], single["target"], 1.0 if i == 0 else 0.02)
        for k, v in b.items():
            fn.inputs[k].copy_(v)
        want.append(fn())
    fmoments = init_moments(torch.device("cuda"))
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    cfg = {"algo": {"critic": {"per_rank_target_network_update_freq": 1, "tau": 0.02}}}
    sfn = make_fused_train_fn(
        fstep, fused["wm"], fused["actor"], fused["critic"], fused["target"], fopts, fmoments, cfg, pregathered, 2, stack, (fgen,)
    )
    got, finite = sfn()
    assert finite.tolist() == [True, True] and sfn.captured_launches == 2 * (8 + 5)
    want = torch.stack(want)
    assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= REPLAY_BOUND
    for k in ("wm", "actor", "critic", "target"):
        for a, b in zip(fused[k].parameters(), single[k].parameters()):
            assert (a - b).abs().max() <= REPLAY_BOUND * b.abs().max().clamp_min(1e-30), k
    for fo, so in zip(fopts, sopts):
        assert int(fo.count) == int(so.count) == 2
        for a, b in zip([*fo.mu, *fo.nu], [*so.mu, *so.nu]):
            assert (a - b).abs().max() <= REPLAY_BOUND * b.abs().max().clamp_min(1e-30)
    torch.testing.assert_close(fmoments.high, smoments.high, atol=REPLAY_BOUND, rtol=REPLAY_BOUND)
    assert torch.equal(fgen.get_state(), sgen.get_state())


@pytest.mark.cuda
def test_cuda_superstep_draws_from_the_ring(cuda):
    """A K = 2 superstep drawing its batches from the ring in the graph (two
    generators registered): finite metrics, the sample stream advanced, and
    the ring untouched."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_fused_train_fn
    from sheeprl_tpu_torch.data.device_buffer import draw_sequence_batch
    from sheeprl_tpu_torch.ops.math import init_moments

    ring, _ = _fed_ring_and_host()
    before = ring.host_arrays()
    models, step, opts = _train(False, "auto", 4)
    bufs, pos, full = ring.superstep_inputs(8)
    gen, sample_gen = (torch.Generator(device="cuda").manual_seed(s) for s in (1, 2))
    cfg = {"algo": {"critic": {"per_rank_target_network_update_freq": 1, "tau": 0.02}}}
    fn = make_fused_train_fn(
        step, models["wm"], models["actor"], models["critic"], models["target"], opts, init_moments(torch.device("cuda")),
        cfg, lambda ctx, i: draw_sequence_batch(bufs, pos, full, sample_gen, 4, 8), 2, None, (gen, sample_gen),
    )
    drawn = sample_gen.get_state()
    for counter in (0, 2):
        fn.inputs["counter"].fill_(counter)
        metrics, finite = fn()
        assert torch.isfinite(metrics).all() and finite.all()
    assert fn.replays == 2 and not torch.equal(sample_gen.get_state(), drawn)
    after = ring.host_arrays()
    assert all(np.array_equal(before[k], after[k]) for k in before)


# --------------------------------------------------------------------------- #
# PPO: the captured update and the fused rollout; Dreamer-V3 at bf16-true
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
def test_cuda_ppo_captured_update_matches_eager(cuda, monkeypatch):
    """The PPO update at exp=ppo widths (bf16-mixed) as one CUDA graph
    against the same update eager, from the same weights and train
    generator: three updates, every parameter within chip_smoke's bound,
    one capture."""
    import chip_smoke

    from sheeprl_tpu_torch.algos.ppo.ppo import opt_state_tensors
    from sheeprl_tpu_torch.ops import graph

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _, g_agent, g_opt, g_gen, g_update, inputs = chip_smoke.ppo_update_models(torch, np, "mlp_cartpole")
    _, e_agent, e_opt, _, e_update, _ = chip_smoke.ppo_update_models(torch, np, "mlp_cartpole")
    captures = graph.capture_count
    fn = graph.CapturedStep(g_update, inputs, opt_state_tensors(g_agent, g_opt), g_gen)
    for _ in range(3):
        got, want = fn(), e_update(inputs)
        assert torch.isfinite(got).all()
    assert fn.replays == 3 and graph.capture_count == captures + 1
    assert int(g_opt.count) == int(e_opt.count) == 3 * 10 * 8
    for a, b in zip(g_agent.parameters(), e_agent.parameters()):
        assert (a - b).abs().max() <= chip_smoke.PPO_UPDATE_BOUND * b.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
def test_cuda_fused_superstep_replay_matches_eager(cuda):
    """The fused rollout (CartPole twin, 16 steps of 4 envs), GAE and the
    update as one CUDA graph against the same superstep eager on the card,
    from the same generator states and env carry: metrics, episode flags,
    the carry and the parameters."""
    from sheeprl_tpu_torch.algos.ppo import agent as tagent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_local_train, opt_state_tensors
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.jittable import get_jittable_env
    from sheeprl_tpu_torch.ops import graph
    from sheeprl_tpu_torch.ops.optim import adam
    from sheeprl_tpu_torch.ops.rollout_scan import init_env_carry, make_onpolicy_superstep_fn

    import chip_smoke

    spec = get_jittable_env("CartPole-v1")
    cfg = chip_smoke.ppo_cfg("exp=ppo", "algo.per_rank_batch_size=16", "algo.update_epochs=2")
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    runs = []
    for _ in range(2):
        agent, _ = tagent.build_agent((2,), False, cfg, space, device="cuda")
        opt = adam(list(agent.parameters()), cfg.algo.optimizer, 0.0)
        gens = [torch.Generator(device="cuda").manual_seed(s) for s in (1, 2, 3)]
        carry = init_env_carry(spec, 4, gens[1])
        superstep = make_onpolicy_superstep_fn(
            spec,
            policy_fn=lambda obs, g, a=agent: tagent.rollout_step(a, obs, g),
            value_fn=lambda obs, a=agent: a(obs)[1],
            local_train=make_local_train(agent, opt, cfg, ["state"], 64, gens[2]),
            obs_key="state",
            rollout_steps=16,
            gamma=0.99,
            gae_lambda=0.95,
            policy_generator=gens[0],
            env_generator=gens[1],
        )
        coefs = torch.tensor([0.2, 0.0], device="cuda")
        runs.append((agent, carry, superstep, coefs, opt, gens))
    (g_agent, g_carry, g_step, coefs, g_opt, g_gens), (e_agent, e_carry, e_step, _, _, _) = runs
    def fused(d):
        metrics, stats = g_step({k: v for k, v in d.items() if k != "coefs"}, d["coefs"])
        return metrics, stats["done"]

    fn = graph.CapturedStep(
        fused,
        {**g_carry, "coefs": coefs},
        opt_state_tensors(g_agent, g_opt) + list(g_carry.values()),
        g_gens,
    )
    for _ in range(2):
        (got, g_done), (want, e_stats) = fn(), e_step(e_carry, coefs)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert torch.equal(g_done, e_stats["done"])
    assert fn.replays == 2
    for k in g_carry:
        torch.testing.assert_close(g_carry[k], e_carry[k], atol=1e-5, rtol=1e-5)
    for a, b in zip(g_agent.parameters(), e_agent.parameters()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_dv3_bf16_true_step_is_bit_equal_to_bf16_mixed(cuda, smooth):
    """Dreamer-V3 keeps fp32 parameters at bf16-true, as the JAX modules
    do: one train step (the fused step reading a bf16 x) bit-equal to the
    step at bf16-mixed from the same weights."""
    mixed, mstep, _ = _train(False, "auto", 4, precision="bf16-mixed")
    true, tstep, _ = _train(False, "auto", 4, _snapshot(mixed), precision="bf16-true")
    assert all(p.dtype == torch.float32 for p in true["wm"].parameters()) and true["wm"].dtype == torch.bfloat16
    batch = _batch(8, 4, False)
    g_m, g_t = {}, {}
    m_m, launches_m, _ = _step(mstep, batch, g_m)
    m_t, launches_t, _ = _step(tstep, batch, g_t)
    assert launches_m == launches_t == 8 + 5 and tgru.bf16_x_launch_count == launches_t
    assert torch.equal(m_m, m_t)
    for k in g_m:
        assert all(torch.equal(a, b) for a, b in zip(g_m[k], g_t[k])), k


@pytest.mark.cuda
def test_cuda_a2c_captured_update_matches_eager(cuda, monkeypatch):
    """The A2C update at exp=a2c widths (bf16-mixed: GAE and one RMSProp
    step) as one CUDA graph against the same update eager: three updates,
    every parameter and RMSProp's nu within chip_smoke's bound."""
    import chip_smoke

    from sheeprl_tpu_torch.algos.ppo.ppo import opt_state_tensors
    from sheeprl_tpu_torch.ops import graph
    from sheeprl_tpu_torch.ops.optim import RMSProp

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _, g_agent, g_opt, g_gen, g_update, inputs = chip_smoke.ppo_update_models(torch, np, "a2c_cartpole")
    _, e_agent, e_opt, _, e_update, _ = chip_smoke.ppo_update_models(torch, np, "a2c_cartpole")
    assert isinstance(g_opt, RMSProp)
    fn = graph.CapturedStep(g_update, inputs, opt_state_tensors(g_agent, g_opt), g_gen)
    for _ in range(3):
        got, want = fn(), e_update(inputs)
        assert torch.isfinite(got).all()
    assert fn.replays == 3
    pairs = list(zip(g_agent.parameters(), e_agent.parameters())) + list(zip(g_opt.nu, e_opt.nu))
    for a, b in pairs:
        assert (a - b).abs().max() <= chip_smoke.PPO_UPDATE_BOUND * b.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [False, True], ids=["padded_chunks", "fixed_windows"])
def test_cuda_recurrent_ppo_captured_update_matches_eager(cuda, monkeypatch, windows):
    """The recurrent update at exp=ppo_recurrent widths (bf16-mixed), the
    host path's padded episode chunks and the fused path's fixed windows
    with resets, as one CUDA graph against the same update eager: two
    updates, every parameter within chip_smoke's bound, one capture."""
    import chip_smoke

    from sheeprl_tpu_torch.algos.ppo.ppo import opt_state_tensors
    from sheeprl_tpu_torch.ops import graph

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _, g_agent, g_opt, g_gen, g_update, inputs = chip_smoke.rppo_update_models(torch, np, windows)
    _, e_agent, _, _, e_update, _ = chip_smoke.rppo_update_models(torch, np, windows)
    captures = graph.capture_count
    fn = graph.CapturedStep(g_update, inputs, opt_state_tensors(g_agent, g_opt), g_gen)
    for _ in range(2):
        got, want = fn(), e_update(inputs)
        assert torch.isfinite(got).all()
    assert fn.replays == 2 and graph.capture_count == captures + 1
    assert int(g_opt.count) == 2 * 8 * 8
    for a, b in zip(g_agent.parameters(), e_agent.parameters()):
        assert (a - b).abs().max() <= chip_smoke.PPO_UPDATE_BOUND * b.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
def test_cuda_recurrent_fused_superstep_is_one_replay_an_update(cuda):
    """The recurrent fused rollout (CartPole twin, 16 steps of 4 envs,
    windows of 4), GAE and the sequence update as one CUDA graph: one
    replay an update, against the same superstep eager on the card from the
    same generator states and carry: metrics, episode flags, the carry (the
    LSTM state and previous actions included) and the parameters."""
    import chip_smoke

    from sheeprl_tpu_torch.algos.ppo.ppo import opt_state_tensors
    from sheeprl_tpu_torch.algos.ppo_recurrent import agent as ragent
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_local_train
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.jittable import get_jittable_env
    from sheeprl_tpu_torch.ops import graph
    from sheeprl_tpu_torch.ops.optim import build_optimizer
    from sheeprl_tpu_torch.ops.rollout_scan import init_recurrent_env_carry, make_recurrent_onpolicy_superstep_fn

    spec = get_jittable_env("CartPole-v1")
    cfg = chip_smoke.ppo_cfg("exp=ppo_recurrent", "algo.update_epochs=2", "algo.per_rank_num_batches=2", "fabric.precision=32-true")
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    runs = []
    for _ in range(2):
        agent, _ = ragent.build_agent((2,), False, cfg, space, device="cuda")
        opt = build_optimizer(list(agent.parameters()), cfg.algo.optimizer, 0.5)
        gens = [torch.Generator(device="cuda").manual_seed(s) for s in (1, 2, 3)]
        carry = init_recurrent_env_carry(spec, 4, gens[1], agent.lstm_hidden_size, 2)
        superstep = make_recurrent_onpolicy_superstep_fn(
            spec,
            policy_fn=lambda obs, pa, h, c, g, a=agent: ragent.recurrent_rollout_step(a, obs, pa, h, c, g),
            value_fn=lambda obs, pa, h, c, a=agent: a(obs, pa, h, c)[1],
            local_train=make_local_train(agent, opt, cfg, ["state"], gens[2], sequence_dones=True),
            obs_key="state",
            rollout_steps=16,
            seq_len=4,
            gamma=0.99,
            gae_lambda=0.95,
            reset_on_done=True,
            policy_generator=gens[0],
            env_generator=gens[1],
        )
        runs.append((agent, carry, superstep, opt, gens))
    (g_agent, g_carry, g_step, g_opt, g_gens), (e_agent, e_carry, e_step, _, _) = runs
    coefs = torch.tensor([0.2, 0.001], device="cuda")

    def fused(d):
        metrics, stats = g_step({k: v for k, v in d.items() if k != "coefs"}, d["coefs"])
        return metrics, stats["done"]

    fn = graph.CapturedStep(fused, {**g_carry, "coefs": coefs}, opt_state_tensors(g_agent, g_opt) + list(g_carry.values()), g_gens)
    for update in range(2):
        (got, g_done), (want, e_stats) = fn(), e_step(e_carry, coefs)
        assert fn.replays == update + 1
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert torch.equal(g_done, e_stats["done"])
    for k in g_carry:
        torch.testing.assert_close(g_carry[k], e_carry[k], atol=1e-5, rtol=1e-5)
    for a, b in zip(g_agent.parameters(), e_agent.parameters()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------- #
# the SAC family: captured updates and the transition ring
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sac", "droq", "sac_ae"])
def test_cuda_sac_family_captured_update_matches_eager(cuda, monkeypatch, name):
    """Each algorithm's update at full width (bf16-mixed) replayed from its
    graphs against the same step functions run eagerly, from the same
    weights and generators: two updates, every state tensor within
    chip_smoke's bound, one capture a graph (SAC-AE: one a gate phase)."""
    import chip_smoke

    from sheeprl_tpu_torch.ops import graph

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    _, got = chip_smoke.sac_family_trainer(torch, np, name)
    _, want = chip_smoke.sac_family_trainer(torch, np, name)
    n_steps = chip_smoke.SAC_MODELS[name][1]
    batch = chip_smoke.sac_family_batch(torch, np, got, n_steps)
    captures = graph.capture_count
    for _ in range(2):
        g = chip_smoke.sac_family_update(torch, got, batch, n_steps, eager=False)
        w = chip_smoke.sac_family_update(torch, want, batch, n_steps, eager=True)
    assert graph.capture_count - captures == len(got.graphs) == {"sac": 1, "droq": 3, "sac_ae": 2}[name]
    for a, b in zip(g, w):
        assert torch.isfinite(a).all() and (a - b).abs().max() <= chip_smoke.SAC_UPDATE_BOUND * b.abs().max().clamp_min(1.0)
    for a, b in zip(got.state_tensors(), want.state_tensors()):
        if a.is_floating_point():
            assert (a - b).abs().max() <= chip_smoke.SAC_UPDATE_BOUND * b.abs().max().clamp_min(1e-30)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_ring_transition_draw_runs_on_the_card(cuda):
    """The transition ring on the card: ``sample_transitions`` gathers the
    rows the host drew, and ``draw_transition_batch`` inside a CUDA graph
    draws only valid items (with the next observation) at every replay."""
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer, draw_transition_batch, transition_item_mask
    from sheeprl_tpu_torch.ops.graph import CapturedStep

    ring = DeviceReplayBuffer(16, n_envs=4, obs_keys=("observations",), device=cuda, seed=0)
    rng = np.random.default_rng(0)
    for i in range(10):
        ring.add({
            "observations": np.full((1, 4, 3), i, np.float32) + np.arange(4, dtype=np.float32)[None, :, None] / 10,
            "actions": rng.standard_normal((1, 4, 1)).astype(np.float32),
            "rewards": rng.standard_normal((1, 4, 1)).astype(np.float32),
            "terminated": np.zeros((1, 4, 1), np.float32),
            "truncated": np.zeros((1, 4, 1), np.float32),
        })
    sample = ring.sample_transitions(32, 2, sample_next_obs=True)
    assert sample["observations"].is_cuda and sample["observations"].shape == (2, 32, 3)
    torch.testing.assert_close(sample["next_observations"], sample["observations"] + 1)
    bufs, pos, full = ring.superstep_inputs(sample_next_obs=True)
    gen = torch.Generator(device=cuda).manual_seed(1)

    def draw(inputs):
        batch = draw_transition_batch(bufs, inputs["pos"], inputs["full"], gen, 64, True, ("observations",))
        return torch.stack([batch["observations"], batch["next_observations"]])

    fn = CapturedStep(draw, {"pos": pos, "full": full}, [], gen)
    seen = set()
    for _ in range(3):
        obs, nxt = fn()
        torch.testing.assert_close(nxt, obs + 1)
        assert bool((obs[:, 0] < 9).all())  # the newest item has no successor yet
        seen.add(obs[:, 0].sum().item())
    assert fn.graph is not None and fn.replays == 3 and len(seen) == 3
    assert int(transition_item_mask(pos, full, 16, True).sum()) == 4 * 9


# --------------------------------------------------------------------------- #
# the serving tier: one CUDA graph a rung, two replicas, hot swap
# --------------------------------------------------------------------------- #


def _commit_linear(ckpt_dir, step, seed):
    import os

    from sheeprl_tpu_torch.resilience.manifest import build_manifest
    from sheeprl_tpu_torch.serve.policy import make_linear_state
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

    state = make_linear_state(in_dim=6, out_dim=3, seed=seed)
    path = os.path.join(str(ckpt_dir), f"ckpt_{step}_0.ckpt")
    save_checkpoint(path, state, manifest=build_manifest(step=step, backend="pickle", world_size=1, state=state))
    return path, state


def _served(kind, device):
    """The linear drill policy, or the exp=ppo MLP (CartPole-v1's spaces,
    seeded weights) as its checkpoint would hold it."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.convert import agent_to_flax
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.serve.policy import build_linear_policy, build_ppo_policy, make_linear_state
    from sheeprl_tpu_torch.utils.utils import dotdict

    if kind == "linear":
        return build_linear_policy({}, make_linear_state(in_dim=6, out_dim=3), device)
    cfg = dotdict(compose("config", ["exp=ppo", "env.capture_video=False", "seed=5"]))
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    agent, _ = build_agent((2,), False, cfg, space, device="cpu")
    return build_ppo_policy(cfg, {"agent": agent_to_flax(agent.state_dict())}, device)


def _requests(policy, n, seed):
    from sheeprl_tpu_torch.serve.loadgen import random_obs

    make, rng = random_obs(policy.obs_spec), np.random.default_rng(seed)
    return [make(rng) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "ppo_mlp"])
def test_cuda_serve_rung_replay_is_bit_equal_to_eager(cuda, kind):
    from sheeprl_tpu_torch.ops import graph
    from sheeprl_tpu_torch.serve.model import ModelStore

    policy = _served(kind, cuda)
    captures = graph.capture_count
    store = ModelStore(policy, [1, 2, 4, 8], step=1, path="x", slots=2)
    assert graph.capture_count - captures == 8  # one graph a rung a slot
    for b in (1, 2, 4, 8):
        obs = _requests(policy, b, seed=b)
        outs = []
        for ladder in store.current.ladders:
            rung = ladder.rung(b)
            outs.append(rung.run(obs))
            assert np.array_equal(outs[-1], rung.eager(obs)), (kind, b)
        assert np.array_equal(*outs)
        # a short batch is zero-padded up to its rung and sliced back
        short = store.current.ladders[0].run(obs[: max(1, b - 1)])
        assert len(short) == max(1, b - 1)


@pytest.mark.cuda
def test_cuda_serve_two_replicas_answer_distinct_concurrent_requests(cuda, tmp_path):
    import threading

    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.policy import build_linear_policy
    from sheeprl_tpu_torch.serve.server import PolicyServer

    path, state = _commit_linear(tmp_path, 100, seed=0)
    policy = build_linear_policy({}, state, cuda)
    cfg = serve_config_from_cfg({"serve": {"num_replicas": 2, "gather_window_ms": 2.0, "slo_ms": 500.0}})
    w, b = state["agent"]["w"].astype(np.float64), state["agent"]["b"].astype(np.float64)
    results, errors = [], []

    def client(seed):
        for obs in _requests(policy, 50, seed):
            try:
                results.append((obs["vector"], server.infer(obs)))
            except Exception as err:  # noqa: BLE001 — every failure is counted
                errors.append(err)

    server = PolicyServer(policy, cfg, step=100, path=path).start()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
        served = [slot.stats.requests for slot in server.replicas.slots]
    finally:
        server.close()
    assert not errors and len(results) == 400
    for vector, out in results:
        np.testing.assert_allclose(out, vector @ w + b, rtol=1e-5, atol=1e-5)
    assert all(n > 0 for n in served), served  # both replicas served, each on its own graphs


@pytest.mark.cuda
def test_cuda_serve_swap_under_load_never_mixes_versions(cuda, tmp_path):
    import threading
    import time

    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.policy import build_linear_policy
    from sheeprl_tpu_torch.serve.server import PolicyServer

    path, old = _commit_linear(tmp_path, 100, seed=0)
    new_path, new = _commit_linear(tmp_path, 200, seed=7)
    policy = build_linear_policy({}, old, cuda)
    # the default SLO, gather window and deadline: a swap must not stall them
    cfg = serve_config_from_cfg({"serve": {"num_replicas": 2}})
    expect = {s: (st["agent"]["w"].astype(np.float64), st["agent"]["b"].astype(np.float64)) for s, st in ((100, old), (200, new))}
    stop = threading.Event()
    records, errors = [], []

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            obs = {"vector": rng.standard_normal(6).astype(np.float32)}
            try:
                req = server.submit(obs)
                records.append((obs["vector"], server.wait(req), req.served_step))
            except Exception as err:  # noqa: BLE001 — every failure is counted
                errors.append(err)

    server = PolicyServer(policy, cfg, step=100, path=path).start()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        assert server.request_swap(new_path).step == 200
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(10.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        stop.set()
        server.close()
    assert not errors, errors[:3]
    snap = server.snapshot()
    assert snap["shed_expired"] == 0 and snap["failed"] == 0, snap
    steps = {s for _, _, s in records}
    assert steps == {100, 200}
    for vector, out, step in records:
        w, b = expect[step]
        other_w, other_b = expect[300 - step]
        np.testing.assert_allclose(out, vector @ w + b, rtol=1e-5, atol=1e-5)
        assert not np.allclose(out, vector @ other_w + other_b, rtol=1e-3, atol=1e-3)


def _fleet(policy, path, **fleet):
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.fleet import FleetServer

    node = {"slo_ms": 500.0, "monitor_interval_s": 0.01, "backoff_base_s": 0.01, "fleet": {"enabled": True, "hedge_scan_ms": 2.0, **fleet}}
    return FleetServer(policy, serve_config_from_cfg({"serve": node}), step=100, path=path)


@pytest.mark.cuda
def test_cuda_fleet_captures_each_slot_and_a_standby_at_activation(cuda, tmp_path):
    """Each device slot of the fleet gets its own graphs on the card (one a
    rung), the CPU-spill slot none (eager on the CPU), and a standby slot is
    captured only when activated, before it is routable; every slot answers
    the linear policy's product."""
    from sheeprl_tpu_torch.ops import graph
    from sheeprl_tpu_torch.serve.policy import build_linear_policy

    path, state = _commit_linear(tmp_path, 100, seed=0)
    policy = build_linear_policy({}, state, cuda)
    server = _fleet(policy, path, num_replicas=2, min_replicas=1, max_replicas=3, cpu_spill_replicas=1)
    captures = graph.capture_count
    server.start()
    try:
        assert graph.capture_count - captures == 2 * 4  # two device slots, ladder [1, 2, 4, 8]
        assert not server.store.has_graphs(2) and server.store.current.ladders[2] is None
        server._activate(server.slots[2], {"reason": "test"})
        assert graph.capture_count - captures == 3 * 4 and server.slots[2].alive
        (capture,) = server.slot_captures
        assert capture["replica"] == 2 and sum(capture["pauses_s"]) >= capture["capture_s"] > 0
        assert capture["pause_s"] == max(capture["pauses_s"])
        w, b = state["agent"]["w"].astype(np.float64), state["agent"]["b"].astype(np.float64)
        obs = _requests(policy, 8, seed=3)
        for index in (0, 1, 2, 3):
            ladder = server.store.current.ladders[index]
            assert ladder.device.type == ("cpu" if index == 3 else "cuda")
            for got, o in zip(ladder.run(obs), obs):
                np.testing.assert_allclose(got, o["vector"] @ w + b, rtol=1e-5, atol=1e-5)
        reqs = [server.submit(o, priority="batch") for o in obs]
        for req, o in zip(reqs, obs):
            np.testing.assert_allclose(server.wait(req), o["vector"] @ w + b, rtol=1e-5, atol=1e-5)
    finally:
        server.close()


@pytest.mark.cuda
def test_cuda_fleet_kill_and_swap_under_load(cuda, tmp_path):
    """Replica 0 killed while clients run, then a swap across every slot:
    nothing dropped, each answer the product of the version stamped on it."""
    import threading
    import time

    from sheeprl_tpu_torch.serve.policy import build_linear_policy

    path, state = _commit_linear(tmp_path, 100, seed=0)
    new_path, new_state = _commit_linear(tmp_path, 200, seed=1)
    expect = {s: (st["agent"]["w"].astype(np.float64), st["agent"]["b"].astype(np.float64)) for s, st in ((100, state), (200, new_state))}
    policy = build_linear_policy({}, state, cuda)
    server = _fleet(policy, path, num_replicas=2, min_replicas=2, max_replicas=2, cpu_spill_replicas=1, spill_depth=0).start()
    stop, records, errors = threading.Event(), [], []

    from sheeprl_tpu_torch.serve.loadgen import random_obs

    def client(seed, priority):
        make, rng = random_obs(policy.obs_spec), np.random.default_rng(seed)
        while not stop.is_set():
            obs = make(rng)
            try:
                req = server.submit(obs, priority=priority)
                records.append((obs["vector"], server.wait(req), req.served_step))
            except Exception as err:  # noqa: BLE001 — the test counts every failure
                errors.append(err)

    threads = [threading.Thread(target=client, args=(i, "batch" if i % 2 else "interactive"), daemon=True) for i in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        assert server.kill_replica(0)
        time.sleep(0.3)
        assert server.request_swap(new_path).step == 200
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(10.0)
    finally:
        stop.set()
        server.close()
    assert not errors, errors[:3]
    assert {s for _, _, s in records} == {100, 200}
    for vector, out, step in records:
        w, b = expect[step]
        np.testing.assert_allclose(out, vector @ w + b, rtol=1e-5, atol=1e-5)
    snap = server.snapshot()
    assert snap["shed_expired"] == 0 and snap["failed"] == 0 and snap["events"].get("replica_killed") == 1


# --------------------------------------------------------------------------- #
# Plan2Explore on Dreamer-V3: the exploration step
# --------------------------------------------------------------------------- #


def _p2e(continuous, state=None, precision="bf16-mixed"):
    """The P2E agent at SMALL_TRAIN widths on the card (seeded, or
    ``state``'s models), its optimizers, Moments and exploration step."""
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as expl
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.algos.p2e_dv3.convert import load_checkpoint_state
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.ops.math import init_moments
    from sheeprl_tpu_torch.utils.utils import dotdict

    env = "dummy_continuous" if continuous else "dummy_discrete"
    overrides = {**SMALL_TRAIN, "fabric.precision": precision, "seed": 3, "algo.horizon": 4, "algo.ensembles.n": 4}
    argv = ["exp=p2e_dv3_exploration", "env=dummy", f"env.id={env}", "algo.mlp_keys.encoder=[state]"]
    cfg = dotdict(compose("config", argv + [f"{k}={v}" for k, v in overrides.items()]))
    space = spaces.Dict(
        {"rgb": spaces.Box(0, 255, (16, 16, 3), np.uint8), "state": spaces.Box(-20, 20, (5,), np.float32)}
    )
    agent = build_agent((2,) if continuous else (3,), continuous, cfg, space, device="cuda")
    if state is not None:
        load_checkpoint_state(state, agent)
    opts = expl.build_optimizers(cfg, agent)
    dev = torch.device("cuda")
    moments = (init_moments(dev), {k: init_moments(dev) for k in agent.critics_exploration})
    return agent, opts, moments, expl.make_train_step(agent, opts, cfg, continuous)


@pytest.mark.cuda
@pytest.mark.parametrize("continuous", [False, True])
def test_cuda_p2e_exploration_replays_match_eager_steps(cuda, smooth, monkeypatch, continuous):
    """Three graph replays of the exploration step (world model, ensemble,
    both imaginations through the fused step, seven optimizers) against
    three eager steps from the same weights and batches, at bf16-mixed:
    metrics, every trained parameter and every Moments. B1 is called
    T + 2 (horizon + 1) times a step, captured once."""
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as expl
    from sheeprl_tpu_torch.algos.p2e_dv3.convert import checkpoint_state

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    graphed, gopts, (gmt, gme), gstep = _p2e(continuous)
    eager, _, (emt, eme), estep = _p2e(continuous, checkpoint_state(graphed, gopts, gmt, gme))
    batches = [_batch(8, 4, continuous, seed=s) for s in range(3)]
    tgru.reset_launch_count()
    metrics = estep(emt, eme, batches[0])
    assert tgru.launch_count == tgru.bf16_x_launch_count == 8 + 2 * 5
    eager, _, (emt, eme), estep = _p2e(continuous, checkpoint_state(graphed, gopts, gmt, gme))
    fn = expl.make_train_fn(gstep, graphed, gopts, gmt, gme, {k: torch.empty_like(v) for k, v in batches[0].items()}, None)
    for b in batches:
        for k, v in b.items():
            fn.inputs[k].copy_(v)
        got = fn()
        want = estep(emt, eme, b)
        assert torch.isfinite(got).all() and got.shape == metrics.shape
        assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= REPLAY_BOUND
    assert fn.replays == 3 and fn.captured_launches == 8 + 2 * 5
    for a, b in zip(
        [p for m in expl.trained_modules(graphed) for p in m.parameters()],
        [p for m in expl.trained_modules(eager) for p in m.parameters()],
    ):
        assert (a - b).abs().max() <= REPLAY_BOUND * b.abs().max().clamp_min(1e-30)
    for a, b in [(gmt, emt)] + [(gme[k], eme[k]) for k in gme]:
        torch.testing.assert_close(a.high, b.high, atol=REPLAY_BOUND, rtol=REPLAY_BOUND)


# --------------------------------------------------------------------------- #
# placement, PPO's overlapped collection and Dreamer-V2
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
def test_cuda_placed_player_copy_is_bit_equal(cuda, stream):
    """A player on the host copies the learner's card modules in one flat
    transfer a dtype (pinned, on a side stream with ``stream``): stale
    until landed, bit-equal after; a player on the card over a learner on
    the host (``train_device=cpu``) alike."""
    from sheeprl_tpu_torch.parallel.fabric import HostPlayerParams, place_player

    class Player(HostPlayerParams):
        _placed_attrs = ("agent",)

        def __init__(self, agent, device):
            self.agent, self.device = agent, device

    for learner, target in ((cuda, torch.device("cpu")), (torch.device("cpu"), cuda)):
        agent = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.LayerNorm(256), torch.nn.Linear(256, 4)).to(learner)
        agent[2].to(torch.bfloat16)
        player = place_player(Player(agent, learner), target)
        assert player.device == target and player.params_match()
        with torch.no_grad():
            for p in agent.parameters():
                p.add_(1.0)
        assert not player.params_match()
        if stream:
            player.stream_params()
            player.flush_params()
        else:
            player.sync_params()
        assert player.params_match()
        for a, b in zip(agent.parameters(), player.agent.parameters()):
            assert b.device.type == target.type and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_cuda_overlapped_update_leaves_the_player_snapshot_untouched(cuda):
    """PPO's update replayed on a side stream while the player's snapshot,
    refreshed only by ``sync_params`` after the update's event, acts on the
    default stream: the snapshot holds the params from before the update
    until then, and the update equals the same update replayed alone."""
    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.ops.graph import CapturedStep
    from sheeprl_tpu_torch.ops.optim import build_optimizer
    from sheeprl_tpu_torch.parallel.fabric import place_player
    from sheeprl_tpu_torch.utils.utils import dotdict

    cfg = dotdict(compose("config", ["exp=ppo", "env.capture_video=False", "seed=5"]))
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    rng = np.random.default_rng(0)
    T, E = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
    inputs = {
        "state": torch.from_numpy(rng.standard_normal((T, E, 4)).astype(np.float32)).cuda(),
        "dones": torch.from_numpy((rng.uniform(size=(T, E, 1)) < 0.05).astype(np.float32)).cuda(),
        "values": torch.from_numpy(rng.standard_normal((T, E, 1)).astype(np.float32)).cuda(),
        "actions": torch.from_numpy(np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, E))]).cuda(),
        "logprobs": torch.from_numpy(-rng.uniform(0.5, 1.0, (T, E, 1)).astype(np.float32)).cuda(),
        "rewards": torch.ones(T, E, 1, device="cuda"),
        "next/state": torch.zeros(E, 4, device="cuda"),
        "coefs": torch.tensor([0.2, 0.0], device="cuda"),
    }
    outs = []
    for overlapped in (True, False):
        agent, player = build_agent((2,), False, cfg, space, device="cuda")
        opt = build_optimizer(list(agent.parameters()), cfg.algo.optimizer, float(cfg.algo.max_grad_norm))
        gen = torch.Generator(device="cuda").manual_seed(1)
        n = T * E
        fn = CapturedStep(ppo.make_update_fn(agent, ppo.make_local_train(agent, opt, cfg, ["state"], n, gen), cfg, ["state"]), inputs, ppo.opt_state_tensors(agent, opt), gen)
        place_player(player, cuda, snapshot=True)
        before = [p.clone() for p in player.agent.parameters()]
        obs = {"state": rng.standard_normal((E, 4)).astype(np.float32)}
        # the player's rollout graph is captured before any update, as in main()
        pg = torch.Generator(device="cuda").manual_seed(2)
        player.rollout_actions(obs, pg)
        torch.cuda.synchronize()
        if overlapped:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                metrics = fn()
                done = torch.cuda.Event()
                done.record(side)
            for _ in range(8):  # the player acts while the update runs
                player.rollout_actions(obs, pg)
            done.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(player.agent.parameters(), before))
            assert not all(torch.equal(a, b) for a, b in zip(agent.parameters(), before))
            player.sync_params()
            assert player.params_match()
        else:
            metrics = fn()
        torch.cuda.synchronize()
        outs.append((metrics, [p.detach().clone() for p in agent.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0]) and all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.cuda
@pytest.mark.parametrize("continuous", [False, True])
def test_cuda_dreamer_v2_replays_match_eager_steps(cuda, monkeypatch, continuous):
    """Three graph replays of Dreamer-V2's step against three eager steps
    from the same weights and batches at bf16-mixed, the hard target copy
    before each, smooth samplers: metrics and every parameter within
    REPLAY_BOUND; B1 never launched."""
    import chip_smoke
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v2.convert import checkpoint_state, load_checkpoint_state
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.utils.utils import dotdict

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    env = "dummy_continuous" if continuous else "dummy_discrete"
    small = ["algo.dense_units=64", "algo.mlp_layers=2", "algo.world_model.encoder.cnn_channels_multiplier=4", "algo.world_model.recurrent_model.recurrent_state_size=64", "algo.world_model.stochastic_size=8", "algo.world_model.discrete_size=8", "algo.horizon=4"]
    cfg = dotdict(compose("config", ["exp=dreamer_v2", "env=dummy", f"env.id={env}", "algo.mlp_keys.encoder=[state]", "seed=3", "algo.world_model.use_continues=True", *small]))
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-20, 20, (5,), np.float32)})
    adim = (2,) if continuous else (3,)

    def models(state=None):
        wm, actor, critic, target, _ = build_agent(adim, continuous, cfg, space, device="cuda")
        opts = build_optimizers(cfg, wm, actor, critic)
        if state is not None:
            load_checkpoint_state(state, wm, actor, critic, target, opts)
        return (wm, actor, critic, target), opts, dv2.make_train_step(wm, actor, critic, target, *opts, cfg)

    rng = np.random.default_rng(0)

    def batch():
        d = {
            "rgb": rng.integers(0, 256, (8, 4, 64, 64, 3)).astype(np.uint8),
            "state": rng.standard_normal((8, 4, 5)).astype(np.float32),
            "actions": (rng.uniform(-1, 1, (8, 4, 2)) if continuous else np.eye(3)[rng.integers(0, 3, (8, 4))]).astype(np.float32),
            "rewards": rng.standard_normal((8, 4, 1)).astype(np.float32),
            "terminated": (rng.uniform(size=(8, 4, 1)) < 0.05).astype(np.float32),
            "is_first": (rng.uniform(size=(8, 4, 1)) < 0.05).astype(np.float32),
        }
        return {k: torch.from_numpy(v).cuda() for k, v in d.items()}

    batches = [batch() for _ in range(3)]
    with chip_smoke.dv2_deterministic():
        graphed, gopts, gstep = models()
        eager, _, estep = models(checkpoint_state(*graphed, gopts))
        fn = dv2.make_train_fn(gstep, *graphed[:3], gopts, {k: torch.empty_like(v) for k, v in batches[0].items()}, None)
        tgru.reset_launch_count()
        for b in batches:
            for k, v in b.items():
                fn.inputs[k].copy_(v)
            dv2.hard_copy_(graphed[2], graphed[3])
            dv2.hard_copy_(eager[2], eager[3])
            got = fn()
            want = estep(b)
            assert torch.isfinite(got).all() and got.shape == (13,)
            assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= REPLAY_BOUND
    assert fn.replays == 3 and tgru.launch_count == 0
    for a, b in zip([p for m in graphed[:3] for p in m.parameters()], [p for m in eager[:3] for p in m.parameters()]):
        assert (a - b).abs().max() <= REPLAY_BOUND * b.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("exp", ["dreamer_v1", "p2e_dv2_exploration", "p2e_dv1_exploration"])
def test_cuda_dreamer_v1_and_p2e_replays_match_eager_steps(cuda, monkeypatch, exp):
    """Three graph replays of the Dreamer-V1 step and of the P2E-DV2 and
    P2E-DV1 exploration steps against three eager steps from the same
    weights and batches at bf16-mixed (P2E-DV2's targets hard-copied before
    each), smooth samplers: metrics and every trained parameter within
    REPLAY_BOUND; neither B1 nor B2 launched."""
    import chip_smoke
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.utils.utils import dotdict

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    small = ["algo.dense_units=64", "algo.mlp_layers=2", "algo.world_model.encoder.cnn_channels_multiplier=4", "algo.world_model.recurrent_model.recurrent_state_size=64", "algo.world_model.stochastic_size=8", "algo.horizon=4"]
    small += ["algo.world_model.discrete_size=8", "algo.ensembles.n=4"] if exp == "p2e_dv2_exploration" else ["algo.ensembles.n=4"] if exp.startswith("p2e") else []
    cfg = dotdict(compose("config", [f"exp={exp}", "env=dummy", "env.id=dummy_discrete", "algo.mlp_keys.encoder=[state]", "seed=3", "algo.world_model.use_continues=True", *small]))
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-20, 20, (5,), np.float32)})
    rng = np.random.default_rng(0)

    def batch():
        d = {
            "rgb": rng.integers(0, 256, (8, 4, 64, 64, 3)).astype(np.uint8),
            "state": rng.standard_normal((8, 4, 5)).astype(np.float32),
            "actions": np.eye(3)[rng.integers(0, 3, (8, 4))].astype(np.float32),
            "rewards": rng.standard_normal((8, 4, 1)).astype(np.float32),
            "terminated": (rng.uniform(size=(8, 4, 1)) < 0.05).astype(np.float32),
            "is_first": (rng.uniform(size=(8, 4, 1)) < 0.05).astype(np.float32),
        }
        return {k: torch.from_numpy(v).cuda() for k, v in d.items()}

    batches = [batch() for _ in range(3)]
    tgru.reset_launch_count()
    with chip_smoke.family_deterministic():
        graphed = chip_smoke.family_models(torch, exp, cfg, space, (3,), False)
        eager = chip_smoke.family_models(torch, exp, cfg, space, (3,), False, graphed.state())
        fn = graphed.make_fn({k: torch.empty_like(v) for k, v in batches[0].items()}, None)
        for b in batches:
            for k, v in b.items():
                fn.inputs[k].copy_(v)
            graphed.refresh()
            eager.refresh()
            got = fn()
            want = eager.step(b)
            assert torch.isfinite(got).all() and got.shape == (len(graphed.order),)
            assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= REPLAY_BOUND
    assert fn.replays == 3 and tgru.launch_count == 0 and tgru.proj_launch_count == 0
    for a, b in zip([p for m in graphed.modules for p in m.parameters()], [p for m in eager.modules for p in m.parameters()]):
        assert (a - b).abs().max() <= REPLAY_BOUND * b.abs().max().clamp_min(1e-30)


# --------------------------------------------------------------------------- #
# the profilers on the card, and exp=dreamer_v3 on the port's CartPole frames
# --------------------------------------------------------------------------- #


def _kernel_names(path):
    import json

    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]


def _gru_calls(cuda, n):
    args = [torch.tensor(a, device=cuda) for a in _np_args(6, 4, 1027, 512, 512)]
    for _ in range(n):
        tgru.fused_recurrent_step(*args)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_triggered_window_traces_the_kernels(cuda, tmp_path):
    """A triggered window's trace holds the CUDA kernels launched in it:
    B1's two ``gru_step`` launches a call, for the window's calls only."""
    from sheeprl_tpu_torch.obs.profile import TriggeredProfiler

    prof = TriggeredProfiler(str(tmp_path), windows=[2], device=cuda)
    for window in (1, 2, 3):
        prof.on_window(window)
        _gru_calls(cuda, 3)
    (capture,) = prof.finish()
    assert capture["windows"] == [2] and prof.failed_starts == 0
    assert sum("gru_step" in n for n in _kernel_names(f"{capture['trace_dir']}/trace.json")) == 2 * 3


@pytest.mark.cuda
def test_cuda_whole_run_trace_refuses_a_nested_window(cuda, tmp_path):
    """``metric.profiler`` owns the process's one profiler session: a
    triggered window inside it fails to start and is counted, and the
    whole-run trace keeps every kernel."""
    from sheeprl_tpu_torch.obs.profile import TriggeredProfiler
    from sheeprl_tpu_torch.utils.profiler import maybe_profile

    cfg = {"metric": {"profiler": {"enabled": True, "trace_dir": str(tmp_path / "whole")}}}
    prof = TriggeredProfiler(str(tmp_path / "triggered"), windows=[1], device=cuda)
    with maybe_profile(cfg, device=cuda) as trace_dir:
        prof.on_window(1)
        _gru_calls(cuda, 2)
        prof.on_window(2)
    assert prof.failed_starts == 1 and "already open" in prof.last_error and prof.finish() == []
    assert sum("gru_step" in n for n in _kernel_names(f"{trace_dir}/trace.json")) == 2 * 2


@pytest.mark.cuda
def test_cuda_dreamer_v3_trains_on_cartpole_frames(cuda, tmp_path):
    """``exp=dreamer_v3`` as composed (CartPole-v1 frames drawn by the port)
    at small widths on the card: B1 launched, a traced window after the
    step's capture holding ``gru_step`` kernels, and the checkpoint's
    models registered."""
    import glob
    import json
    import pickle

    from sheeprl_tpu_torch import cli

    runs = tmp_path / "RUNS.jsonl"
    argv = [
        "exp=dreamer_v3", "env.capture_video=False", "env.backend=sync", "env.num_envs=2", "algo.total_steps=48",
        "algo.learning_starts=32", "buffer.size=64", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8",
        "algo.horizon=4", "algo.dense_units=32", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
        "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.representation_model.hidden_size=32",
        "algo.world_model.transition_model.hidden_size=32", "algo.world_model.discrete_size=4",
        "algo.world_model.stochastic_size=4", "algo.run_test=False", "metric.telemetry.enabled=True",
        "metric.telemetry.profile_windows=[22]", f"metric.telemetry.runs_jsonl={runs}", f"log_base_dir={tmp_path}/logs",
    ]
    tgru.reset_launch_count()
    cli.run(argv)
    assert tgru.launch_count > 0
    record = [json.loads(line) for line in open(runs)][-1]
    (capture,) = record["profile_captures"]
    assert any("gru_step" in n for n in _kernel_names(f"{capture['trace_dir']}/trace.json"))
    (ckpt,) = glob.glob(f"{tmp_path}/logs/**/checkpoint/*.ckpt", recursive=True)
    cli.registration([f"checkpoint_path={ckpt}", f"model_manager.registry_dir={tmp_path}/registry"])
    index = json.load(open(tmp_path / "registry" / "registry.json"))
    assert len(index) == 5
    with open(index["dreamer_v3_CartPole-v1_actor"][0]["artifact"], "rb") as f:
        assert set(pickle.load(f)) == {"params"}
