"""The plain versions of the port's two kernels against the JAX Pallas
kernels run in interpret mode, on the CPU. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_port_cuda.py
and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r2dm_tpu.models.layers import _folded_gn_coeffs
from r2dm_tpu.ops.pallas_gn import fused_group_norm_silu as jax_gn_silu
from r2dm_tpu.ops.pallas_resconv import fused_act_ringconv as jax_act_ringconv
from r2dm_tpu_torch.ops import act_ringconv, gn_silu


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("apply_silu", [True, False])
def test_gn_silu_plain_matches_pallas(apply_silu):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 32, 16), dtype=np.float32)
    gain = rng.standard_normal(16, dtype=np.float32)
    shift = rng.standard_normal(16, dtype=np.float32)
    ref = jax_gn_silu(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(gain), jnp.asarray(shift),
        num_groups=4, eps=1e-6, apply_silu=apply_silu, interpret=True,
    )
    got = gn_silu.fused_group_norm_silu(
        t(x).to(torch.bfloat16), t(gain), t(shift), 4, 1e-6, apply_silu=apply_silu
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2
    )


def test_gn_silu_plain_per_batch_affine_matches_pallas():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 16, 8), dtype=np.float32)
    gain = rng.standard_normal((3, 8), dtype=np.float32)
    shift = rng.standard_normal((3, 8), dtype=np.float32)
    ref = jax_gn_silu(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(gain), jnp.asarray(shift),
        num_groups=2, eps=1e-6, interpret=True,
    )
    got = gn_silu.fused_group_norm_silu(t(x).to(torch.bfloat16), t(gain), t(shift), 2, 1e-6)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2
    )


@pytest.mark.parametrize("per_batch", [False, True])
def test_gn_coeffs_plain_matches_jax(per_batch):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 32, 16), dtype=np.float32) * 1.5 + 0.3
    shape = (2, 16) if per_batch else (16,)
    gain = rng.standard_normal(shape, dtype=np.float32)
    shift = rng.standard_normal(shape, dtype=np.float32)
    a_ref, b_ref = _folded_gn_coeffs(
        jnp.asarray(x), 4, 1e-6, jnp.asarray(gain), jnp.asarray(shift), "NHWC"
    )
    before = gn_silu.gn_coeffs.launches
    a, b = gn_silu.gn_coeffs(t(x), 4, 1e-6, t(gain), t(shift))
    assert gn_silu.gn_coeffs.launches == before  # CPU tensors take the plain version
    assert a.dtype == b.dtype == torch.float32 and a.shape == (2, 16)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), atol=1e-5)


@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("cin", [64, 128])
def test_act_ringconv_plain_matches_pallas(apply_act, cin):
    rng = np.random.default_rng(0)
    B, H, W, F = 2, 8, 64, 64
    x = rng.standard_normal((B, H, W, cin), np.float32)
    a = rng.standard_normal((B, cin), np.float32) * 0.5 + 1.0
    b = rng.standard_normal((B, cin), np.float32) * 0.2
    k = rng.standard_normal((3, 3, cin, F), np.float32) * 0.1
    bias = rng.standard_normal((F,), np.float32) * 0.1
    ref = jax_act_ringconv(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(k), jnp.asarray(bias),
        apply_act=apply_act, interpret=True,
    )
    before = act_ringconv.fused_act_ringconv.launches
    got = act_ringconv.fused_act_ringconv(t(x), t(a), t(b), t(k), t(bias), apply_act=apply_act)
    assert act_ringconv.fused_act_ringconv.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_act_ringconv_pads_h_after_the_activation():
    """silu(b) != 0, so a pad row must contribute zero: the top output row
    of a one-row-high input sees only its own row through the middle taps."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 1, 16, 8), np.float32)
    a = np.ones((1, 8), np.float32)
    b = np.full((1, 8), 3.0, np.float32)
    k = np.zeros((3, 3, 8, 8), np.float32)
    k[0] = k[2] = 1.0  # taps that only ever read the H pad rows
    got = act_ringconv.fused_act_ringconv(t(x), t(a), t(b), t(k), torch.zeros(8))
    np.testing.assert_array_equal(got.numpy(), 0.0)
