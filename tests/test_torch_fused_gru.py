"""The port's fused RSSM step (sheeprl_tpu_torch/ops/fused_gru.py) against
the JAX package's (sheeprl_tpu/ops/pallas_gru.py).

On the CPU the port's wrapper computes its plain version; the JAX side runs
as its own tests run it: ``reference_step`` and the Pallas kernel in
interpret mode. Bounds are the JAX package's own for its kernel
(tests/test_ops/test_pallas_gru.py): 1e-5 on the forward, 1e-4 on the
gradients, all fp32. The CUDA kernel itself is held to the same bounds on
the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_gru as jgru
from sheeprl_tpu_torch.algos.dreamer_v3.agent import FusedRecurrentModel, RecurrentModel, resolve_backend
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


def _torch(args, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in args]


@pytest.mark.parametrize("batch", [1, 5, 16])
def test_forward_matches_jax_reference_and_pallas_kernel(batch):
    args = _np_args(0, batch=batch)
    got = tgru.fused_recurrent_step(*_torch(args)).numpy()
    want_ref = np.asarray(jgru.reference_step(*map(jnp.asarray, args)))
    want_kernel = np.asarray(jgru.fused_recurrent_step(*map(jnp.asarray, args), interpret=True))
    assert got.shape == (batch, 8)
    np.testing.assert_allclose(got, want_ref, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(got, want_kernel, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("batch", [1, 5, 16])
def test_gradients_of_all_nine_inputs_match_jax(batch):
    args = _np_args(1, batch=batch)
    leaves = _torch(args, grad=True)
    tgru.fused_recurrent_step(*leaves).square().sum().backward()

    def loss(fn, **kw):
        return lambda *a: jnp.sum(jnp.square(fn(*a, **kw)))

    jargs = tuple(map(jnp.asarray, args))
    g_ref = jax.grad(loss(jgru.reference_step), argnums=tuple(range(9)))(*jargs)
    g_kernel = jax.grad(loss(jgru.fused_recurrent_step, interpret=True), argnums=tuple(range(9)))(*jargs)
    for t, gr, gk in zip(leaves, g_ref, g_kernel):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gr), atol=GRAD_TOL, rtol=GRAD_TOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gk), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_backward_skips_inputs_that_need_no_gradient():
    args = _np_args(2)
    leaves = _torch(args)
    leaves[6].requires_grad_(True)  # only w2
    out = tgru.fused_recurrent_step(*leaves)
    (g,) = torch.autograd.grad(out.sum(), [leaves[6]])
    ref = [torch.tensor(a) for a in args]
    ref[6].requires_grad_(True)
    (want,) = torch.autograd.grad(tgru.reference_step(*ref).sum(), [ref[6]])
    torch.testing.assert_close(g, want, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_cpu_path_launches_no_kernel():
    before = tgru.launch_count
    tgru.fused_recurrent_step(*_torch(_np_args(3)))
    assert tgru.launch_count == before


@pytest.mark.parametrize(
    "index, bad, error",
    [
        (0, lambda t: t.double(), TypeError),  # x not fp32
        (6, lambda t: t[:, :-3], ValueError),  # w2 columns
        (2, lambda t: t.t().contiguous().t(), ValueError),  # w1 not contiguous
        (1, lambda t: t[:2], ValueError),  # h rows != x rows
        (3, lambda t: t[:-1], ValueError),  # b1 shorter than D
        (7, lambda t: t.half(), TypeError),  # g2 not fp32
        (0, lambda t: t[0], ValueError),  # x not [B, X]
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(index, bad, error):
    args = _torch(_np_args(4))
    args[index] = bad(args[index])
    with pytest.raises(error):
        tgru.fused_recurrent_step(*args)


def test_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgru.launch(*_torch(_np_args(5)))


def _recurrent_pair(in_dim=10, hidden=8, dense=12, seed=0):
    plain = RecurrentModel(in_dim, hidden, dense)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3 + (1.0 if p.dim() == 1 else 0.0))
    fused = FusedRecurrentModel(in_dim, hidden, dense)
    fused.load_state_dict(plain.state_dict())
    return plain, fused


def test_fused_model_matches_plain_model_on_one_state_dict():
    plain, fused = _recurrent_pair()
    x = torch.randn(2, 3, 10)
    h = torch.randn(2, 3, 8)
    torch.testing.assert_close(fused(x, h), plain(x, h), atol=FWD_TOL, rtol=FWD_TOL)


def test_fused_model_matches_jax_recurrent_model():
    """Converted flax RecurrentModel params drive both port models."""
    from sheeprl_tpu.algos.dreamer_v3.agent import RecurrentModel as JaxRecurrentModel

    jm = JaxRecurrentModel(8, 12)
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 10), jnp.float32)
    h = jax.random.normal(jax.random.PRNGKey(3), (4, 8), jnp.float32)
    params = jm.init(jax.random.PRNGKey(4), x, h)
    want = np.asarray(jm.apply(params, x, h))
    p = jax.tree.map(np.asarray, params)["params"]
    sd = {
        "in_kernel": p["Dense_0"]["kernel"],
        "in_bias": p["Dense_0"]["bias"],
        "in_norm.weight": p["LayerNorm_0"]["LayerNorm_0"]["scale"],
        "in_norm.bias": p["LayerNorm_0"]["LayerNorm_0"]["bias"],
        "gru.kernel": p["LayerNormGRUCell_0"]["Dense_0"]["kernel"],
        "gru.norm.weight": p["LayerNormGRUCell_0"]["LayerNorm_0"]["LayerNorm_0"]["scale"],
        "gru.norm.bias": p["LayerNormGRUCell_0"]["LayerNorm_0"]["LayerNorm_0"]["bias"],
    }
    for cls in (RecurrentModel, FusedRecurrentModel):
        m = cls(10, 8, 12)
        m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
        got = m(torch.tensor(np.asarray(x)), torch.tensor(np.asarray(h))).detach().numpy()
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize(
    "mode, fused",
    [("auto", True), ("pallas", True), (True, True), ("flax", False), (False, False), (None, False)],
)
def test_backend_choice(mode, fused):
    assert resolve_backend(mode) is fused


def test_backend_choice_rejects_unknown_mode():
    with pytest.raises(ValueError):
        resolve_backend("bogus")


def test_find_nvcc_raises_without_nvcc(monkeypatch, tmp_path):
    from sheeprl_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()


def test_find_nvcc_looks_under_cuda_home(monkeypatch, tmp_path):
    from sheeprl_tpu_torch.ops import _build

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(nvcc)


def test_nvcc_command_targets_sm90a():
    from sheeprl_tpu_torch.ops import _build

    cmd = _build.nvcc_command("fused_gru", "/tmp/x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-fPIC"} <= set(cmd)
    assert cmd[-1].endswith("csrc/fused_gru.cu")
