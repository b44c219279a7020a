"""The port's model-sharded RSSM step (sheeprl_tpu_torch/ops/fused_gru.py::
sharded_recurrent_step, on a torch.distributed (data, model) mesh) against
the JAX package's (sheeprl_tpu/ops/pallas_gru.py::sharded_recurrent_step on a
2 x 4 device mesh, and reference_step).

The port runs on gloo ranks spawned on the CPU (sheeprl_tpu_torch/parallel/
launch.py; rank bodies in tests/torch_sharded_ranks.py, which imports no
JAX), one spawn per layout: 8 ranks as 2 data x 4 model, 4 ranks as 1 x 4.
On the CPU the projection's wrapper computes its plain version; the JAX side
runs its Pallas projection in interpret mode on the test run's 8 virtual CPU
devices. Bounds: the JAX package's own, 1e-5 on the forward and 1e-4 on the
gradients, all fp32 (tests/test_ops/test_pallas_gru.py). With the W2 slice
stored in bf16 both sides upcast the same values, so the forward keeps 1e-5;
dW2 is rounded to bf16 on both sides and is held at 2 bf16 ulps (rtol 8e-3)
with atol 1e-4. The CUDA kernel itself is held to its plain version on the
card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_gru as jgru
from sheeprl_tpu_torch.algos.dreamer_v3.convert import shard_recurrent
from sheeprl_tpu_torch.ops import fused_gru as tgru
from sheeprl_tpu_torch.parallel import launch
from sheeprl_tpu_torch.parallel import mesh as tmesh
from tests import torch_sharded_ranks as ranks

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_RTOL = 8e-3
BF16_ATOL = 1e-4
HIDDEN = 8
SPAWN_TIMEOUT = 120
# port layout -> (data, model, the JAX step's data_axis on its 2 x 4 mesh)
LAYOUTS = {"2x4": (2, 4, "data"), "1x4": (1, 4, None)}


def _np_args(seed, batch=4, in_dim=12, dense=16, hidden=HIDDEN):
    """The widths of test_pallas_gru.py::_random_args, drawn with numpy."""
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


def _gate_major(parts):
    """Inverse of shard_recurrent's cut: per-rank [..., 3*hs] slices back to
    the full [..., 3H]."""
    lead = parts[0].shape[:-1]
    hs = parts[0].shape[-1] // 3
    return np.concatenate([p.reshape(*lead, 3, hs) for p in parts], -1).reshape(*lead, 3 * hs * len(parts))


def _jax_side(args, data_axis, bf16):
    """Forward of JAX's sharded step (kernel and plain projection) and of
    reference_step, and the gradients of sum(h'**2) through both."""
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    jargs = list(map(jnp.asarray, args))
    if bf16:
        jargs[6] = jargs[6].astype(jnp.bfloat16)
    ref_args = list(jargs)
    ref_args[6] = ref_args[6].astype(jnp.float32)

    def sharded(use_pallas):
        return functools.partial(
            jgru.sharded_recurrent_step, mesh=mesh, data_axis=data_axis, use_pallas=use_pallas, interpret=True
        )

    def grads(fn, a):
        loss = lambda *v: jnp.sum(jnp.square(fn(*v)))  # noqa: E731
        return [f32(g) for g in jax.jit(jax.grad(loss, argnums=tuple(range(9))))(*a)]

    # jit only to cut the op-by-op dispatch of shard_map and interpret mode
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))  # noqa: E731
    return types.SimpleNamespace(
        fwd={p: f32(jax.jit(sharded(p))(*jargs)) for p in (True, False)},
        ref=f32(jgru.reference_step(*ref_args)),
        grads=grads(sharded(True), jargs),
        ref_grads=grads(jgru.reference_step, ref_args),
    )


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout(request, tmp_path_factory):
    """One spawn of the port's ranks for the layout, and the JAX side."""
    data, model, data_axis = LAYOUTS[request.param]
    args = _np_args(7)
    workdir = tmp_path_factory.mktemp(f"sharded_{request.param}")
    np.savez(workdir / "in.npz", **{f"a{i}": a for i, a in enumerate(args)})
    launch.run(ranks.sharded_step, data * model, data, model, str(workdir / "in.npz"), str(workdir), device="cpu", timeout=SPAWN_TIMEOUT)
    outs = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(data * model)]
    return types.SimpleNamespace(
        data=data,
        model=model,
        args=args,
        outs=outs,
        jax={tag: _jax_side(args, data_axis, tag == "bf16") for tag in ("fp32", "bf16")},
    )


def _rank(res, di, mi):
    return res.outs[di * res.model + mi]


def _forward(res, key):
    """The port's h' over the whole batch; every model rank holds it alike."""
    rows = []
    for di in range(res.data):
        got = _rank(res, di, 0)[key]
        for mi in range(1, res.model):
            np.testing.assert_array_equal(_rank(res, di, mi)[key], got)
        rows.append(got)
    return np.concatenate(rows)


def _gradient(res, tag, i):
    """The port's global gradient of input i, put together from the ranks."""
    key = f"{tag}_grad{i}"
    if i < 2:  # data-sharded x, h: whole on every model rank of a data row
        for di in range(res.data):
            for mi in range(1, res.model):
                np.testing.assert_allclose(_rank(res, di, mi)[key], _rank(res, di, 0)[key], atol=1e-7, rtol=0)
        return np.concatenate([_rank(res, di, 0)[key] for di in range(res.data)])
    if i < 6:  # replicated weights: whole on every rank after the data-axis sum
        for out in res.outs[1:]:
            np.testing.assert_allclose(out[key], res.outs[0][key], atol=1e-7, rtol=0)
        return res.outs[0][key]
    return _gate_major([_rank(res, 0, mi)[key] for mi in range(res.model)])  # model-sharded slices


# --------------------------------------------------------------------------- #
# the sharded step on gloo ranks
# --------------------------------------------------------------------------- #


# On CPU tensors sharded_proj computes proj_reference, so the two port cases
# run the same code here; they differ from each other only on the card
# (chip_smoke.py phase 4(b) runs both there). Each is still held to its own
# JAX side: the Pallas projection in interpret mode, and the plain one.
@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_matches_jax_sharded_step_and_reference(layout, use_pallas):
    got = _forward(layout, f"fp32_fwd_{int(use_pallas)}")
    want = layout.jax["fp32"]
    assert got.shape == (4, HIDDEN)
    np.testing.assert_allclose(got, want.fwd[use_pallas], atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(got, want.ref, atol=FWD_TOL, rtol=FWD_TOL)


def test_gradients_of_all_nine_inputs_match_jax(layout):
    want = layout.jax["fp32"]
    for i in range(9):
        got = _gradient(layout, "fp32", i)
        np.testing.assert_allclose(got, want.grads[i], atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"input {i}")
        np.testing.assert_allclose(got, want.ref_grads[i], atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"input {i}")


def test_bf16_w2_storage_matches_jax(layout):
    want = layout.jax["bf16"]
    for use_pallas in (True, False):
        got = _forward(layout, f"bf16_fwd_{int(use_pallas)}")
        np.testing.assert_allclose(got, want.fwd[use_pallas], atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(got, want.ref, atol=FWD_TOL, rtol=FWD_TOL)
    for i in range(9):
        got = _gradient(layout, "bf16", i)
        if i == 6:  # dW2, rounded to bf16 on both sides
            np.testing.assert_allclose(got, want.grads[i], atol=BF16_ATOL, rtol=BF16_RTOL)
        else:
            np.testing.assert_allclose(got, want.grads[i], atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"input {i}")


def test_mesh_lays_ranks_out_row_major(layout):
    for rank, out in enumerate(layout.outs):
        assert out["coords"].tolist() == [rank // layout.model, rank % layout.model]
        assert out["sizes"].tolist() == [layout.data, layout.model]
        assert str(out["model_axis"]) == "model"


def test_indivisible_hidden_is_rejected_on_the_mesh(layout):
    for out in layout.outs:
        assert "must divide" in str(out["rejected"])


def test_gloo_ranks_launch_no_kernel(layout):
    assert all(int(out["proj_launches"]) == 0 for out in layout.outs)


# --------------------------------------------------------------------------- #
# the projection alone, in this process
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("w2_dtype", ["fp32", "bf16"])
def test_sharded_proj_matches_jax_projection(w2_dtype):
    """Forward and the three backward products against the JAX custom-VJP
    projection (interpret mode), at one rank's slice of the 4-way cut."""
    args = _np_args(3)
    x, h, w1, b1, g1, be1, w2, *_ = args
    feat = np.asarray(jax.nn.silu(jnp.asarray(x) @ jnp.asarray(w1)))
    w2s = shard_recurrent(args, 4, 1)[6].numpy()
    jw = jnp.asarray(w2s)
    if w2_dtype == "bf16":
        jw = jw.astype(jnp.bfloat16)
    proj = jgru._make_sharded_proj(True)
    cot = np.random.default_rng(4).standard_normal((4, w2s.shape[1])).astype(np.float32)
    want, vjp = jax.vjp(proj, jnp.asarray(h), jnp.asarray(feat), jw)
    want_grads = [np.asarray(jnp.asarray(g, jnp.float32)) for g in vjp(jnp.asarray(cot))]

    tw = torch.tensor(w2s)
    if w2_dtype == "bf16":
        tw = tw.to(torch.bfloat16)
    leaves = [torch.tensor(h, requires_grad=True), torch.tensor(feat, requires_grad=True), tw.requires_grad_(True)]
    before = tgru.proj_launch_count
    got = tgru.sharded_proj(*leaves)
    assert tgru.proj_launch_count == before  # the plain version ran on the CPU tensors
    got.backward(torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(leaves[0].grad.numpy(), want_grads[0], atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(leaves[1].grad.numpy(), want_grads[1], atol=GRAD_TOL, rtol=GRAD_TOL)
    assert leaves[2].grad.dtype == leaves[2].dtype
    rtol, atol = (GRAD_TOL, GRAD_TOL) if w2_dtype == "fp32" else (BF16_RTOL, BF16_ATOL)
    np.testing.assert_allclose(leaves[2].grad.float().numpy(), want_grads[2], atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "index, bad, error",
    [
        (0, lambda t: t.double(), TypeError),  # h not fp32
        (2, lambda t: t.half(), TypeError),  # w2s neither fp32 nor bf16
        (2, lambda t: t[:-1], ValueError),  # w2s rows != H + D
        (1, lambda t: t[:2], ValueError),  # feat rows != h rows
        (2, lambda t: t.t().contiguous().t(), ValueError),  # w2s not contiguous
        (0, lambda t: t[0], ValueError),  # h not [B, H]
    ],
)
def test_sharded_proj_rejects_what_the_kernel_does_not_take(index, bad, error):
    args = [torch.randn(3, 8), torch.randn(3, 16), torch.randn(24, 6)]
    args[index] = bad(args[index])
    with pytest.raises(error):
        tgru.sharded_proj(*args)


def test_proj_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgru.proj_launch(torch.randn(3, 8), torch.randn(3, 16), torch.randn(24, 6))


# --------------------------------------------------------------------------- #
# shard_recurrent
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mp", [1, 2, 4, 8])
def test_shard_recurrent_cuts_gate_major(mp):
    args = _np_args(5)
    hs = HIDDEN // mp
    slices = [shard_recurrent(args, mp, idx) for idx in range(mp)]
    for idx, got in enumerate(slices):
        assert len(got) == 9 and all(t.dtype == torch.float32 for t in got)
        for i in range(6):
            np.testing.assert_array_equal(got[i].numpy(), args[i])
        want = args[6].reshape(HIDDEN + 16, 3, HIDDEN)[..., idx * hs : (idx + 1) * hs]
        np.testing.assert_array_equal(got[6].numpy(), want.reshape(HIDDEN + 16, 3 * hs))
        for i in (7, 8):
            np.testing.assert_array_equal(got[i].numpy(), args[i].reshape(3, HIDDEN)[:, idx * hs : (idx + 1) * hs].ravel())
    for i in (6, 7, 8):
        np.testing.assert_array_equal(_gate_major([s[i].numpy() for s in slices]), args[i])


def test_shard_recurrent_takes_the_flax_subtree_and_stores_bf16():
    args = _np_args(6)
    _, _, w1, b1, g1, be1, w2, g2, be2 = args
    subtree = {
        "Dense_0": {"kernel": w1, "bias": b1},
        "LayerNorm_0": {"LayerNorm_0": {"scale": g1, "bias": be1}},
        "LayerNormGRUCell_0": {
            "Dense_0": {"kernel": w2},
            "LayerNorm_0": {"LayerNorm_0": {"scale": g2, "bias": be2}},
        },
    }
    want = shard_recurrent(args, 2, 1)[2:]
    for tree in (subtree, {"params": {"recurrent_model": subtree}}):
        got = shard_recurrent(tree, 2, 1, dtype=torch.bfloat16)
        assert len(got) == 7 and got[4].dtype == torch.bfloat16
        assert all(t.dtype == torch.float32 for i, t in enumerate(got) if i != 4)
        torch.testing.assert_close(got[4], want[4].to(torch.bfloat16), atol=0, rtol=0)
        for a, b in zip(got[:4] + got[5:], want[:4] + want[5:]):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("mp, idx", [(3, 0), (4, 4), (2, -1)])
def test_shard_recurrent_rejects_a_bad_cut(mp, idx):
    with pytest.raises(ValueError):
        shard_recurrent(_np_args(0), mp, idx)


# --------------------------------------------------------------------------- #
# the mesh and the launcher
# --------------------------------------------------------------------------- #


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tmesh.make_mesh(1, 1, "cuda")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tmesh.init_distributed("cuda", "file:///nonexistent", 1, 0)


def test_cuda_mesh_without_nccl_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        tmesh.backend_for("cuda")
    assert tmesh.backend_for("cpu") == "gloo"


def test_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(1, 1, "cpu")


def test_launch_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        launch.run(ranks.fail_on_rank_one, 2, device="cpu", timeout=SPAWN_TIMEOUT)


def test_launch_times_out_and_stops_its_ranks():
    with pytest.raises(TimeoutError, match="still running"):
        launch.run(ranks.hang, 2, 600, device="cpu", timeout=3)


def test_launch_defaults_to_the_card_and_raises_without_one():
    """``device=None`` means CUDA ranks: with no card the launcher raises
    before it spawns anything, and never falls back to gloo ranks."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="none is available"):
        launch.run(ranks.hang, 2, 600, timeout=3)
