"""The arithmetic of the sharded projection's tensor-core route
(sheeprl_tpu_torch/csrc/fused_gru.cu::proj_tc), emulated in plain torch on
the CPU, against the port's plain ``proj_reference`` and the JAX package's
projection (sheeprl_tpu/ops/pallas_gru.py::_make_sharded_proj, its Pallas
kernel in interpret mode).

The kernel multiplies bf16 weights on the tensor cores, which take bf16
operands only. It splits each fp32 activation into bf16 planes,
a = a0 + a1 + a2, multiplies each plane by the weights (a product of two bf16
values is exact in fp32), sums each 32-deep tile apart and adds the tile sums
to a running fp32 sum. The emulation below does the same on the CPU. At the
depths of Dreamer-V3 L on a 4-way and XL on a 16-way model axis, three planes
stay within the kernel's 1e-5 bound; one plane (the activations rounded to
bf16) computes another function and does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sheeprl_tpu.ops import pallas_gru as jgru
from sheeprl_tpu_torch.ops import fused_gru as tgru

FWD_TOL = 1e-5
K_TILE = 32
BATCH = 8
# one rank's (H, D, C = 3H/mp) of the sharded step
SHAPES = {"L_mp4": (2048, 768, 1536), "XL_mp16": (4096, 1024, 768)}


def _inputs(hidden, dense, cols):
    """h a GRU state in (-1, 1), feat a SiLU output, W2s scaled by 1/sqrt(depth)
    and stored in bf16, drawn with numpy."""
    rng = np.random.default_rng(hidden + cols)
    h = np.tanh(rng.standard_normal((BATCH, hidden))).astype(np.float32)
    f = rng.standard_normal((BATCH, dense)).astype(np.float32)
    feat = f / (1.0 + np.exp(-f))
    w2 = (rng.standard_normal((hidden + dense, cols)) * (hidden + dense) ** -0.5).astype(np.float32)
    return torch.from_numpy(h), torch.from_numpy(feat.astype(np.float32)), torch.from_numpy(w2).bfloat16()


def _split(a, planes):
    """a as the sum of ``planes`` bf16 values, largest first, each as fp32."""
    out, rest = [], a
    for _ in range(planes):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def _emulated(h, feat, w2s, planes):
    """The tensor-core route's sums: per 32-deep tile, the planes' products
    (smallest plane first) summed in fp32, then added to a running fp32 sum."""
    a = torch.cat([h, feat], 1)
    w = w2s.float()
    pad = -a.shape[1] % K_TILE
    a, w = F.pad(a, (0, pad)), F.pad(w, (0, 0, 0, pad))
    parts = _split(a, planes)
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k in range(0, a.shape[1], K_TILE):
        tile = torch.zeros_like(acc)
        for p in reversed(parts):
            tile = tile + p[:, k : k + K_TILE] @ w[k : k + K_TILE]
        acc = acc + tile
    return acc


def test_split_is_exact_to_fp32():
    """Three bf16 planes hold every bit of an fp32 activation: their fp64 sum
    is the activation itself, and no plane carries more than bf16's bits."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    parts = _split(a, 3)
    assert all(torch.equal(p, p.bfloat16().float()) for p in parts)
    assert torch.equal(sum(p.double() for p in parts), a.double())


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tensor_core_arithmetic(shape, planes):
    h, feat, w2s = _inputs(*SHAPES[shape])
    got = _emulated(h, feat, w2s, planes)
    ref_err = (got - tgru.proj_reference(h, feat, w2s)).abs().max().item()
    w2_bf16 = jnp.asarray(w2s.float().numpy()).astype(jnp.bfloat16)  # the same values
    jax_out = jgru._make_sharded_proj(True)(jnp.asarray(h.numpy()), jnp.asarray(feat.numpy()), w2_bf16)
    jax_err = (got - torch.from_numpy(np.array(jax_out))).abs().max().item()
    if planes == 3:
        assert ref_err <= FWD_TOL and jax_err <= FWD_TOL
    else:  # the activations rounded to bf16: another function
        assert ref_err > FWD_TOL and jax_err > FWD_TOL
