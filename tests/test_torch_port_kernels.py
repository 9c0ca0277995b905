"""The plain versions of the port's two kernels against the JAX Pallas
kernels run in interpret mode, on the CPU. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_port_cuda.py
and chip_smoke.py)."""

import importlib.util
from pathlib import Path

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


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (B, H, W, C, G): every GroupNorm input of config H at b8, then odd shapes:
# H*W < CLUSTER (empty shares), C = 8, C = 2048, C = 40 with G = 5, and
# G > CLUSTER (a rank owns two groups)
GN_LAUNCH_SHAPES = [(8, H, W, C, 8) for C, H, W in _chip_smoke().GN_SHAPES] + [
    (2, 1, 5, 16, 4), (1, 3, 3, 8, 1), (9, 2, 7, 8, 8), (1, 4, 33, 2048, 8),
    (3, 5, 7, 40, 5), (2, 3, 11, 64, 32),
]


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
    a, b = gn_silu.gn_coeffs_plain(t(x), 4, 1e-6, t(gain), t(shift))
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


@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("B,H,W,C,F", [(2, 3, 20, 16, 24), (1, 1, 8, 8, 8), (3, 2, 12, 24, 72)])
def test_packed_weight_implicit_gemm_matches_plain(B, H, W, C, F, apply_act):
    """The conv rebuilt as the CUDA kernel computes it, in fp32: for each
    output row h and kernel row kh whose input row lies inside [0, H) (rows
    in the H padding are skipped), each tap kw multiplies the ring-wrapped
    halo (W index taken mod W) by its (F, C) block of the packed weight."""
    rng = np.random.default_rng(4)
    x = t(rng.standard_normal((B, H, W, C), np.float32))
    a = t(rng.standard_normal((B, C), np.float32) * 0.5 + 1.0)
    b = t(rng.standard_normal((B, C), np.float32) * 0.5 + 2.0)  # silu(b) far from 0
    k = t(rng.standard_normal((3, 3, C, F), np.float32) * 0.1)
    bias = t(rng.standard_normal((F,), np.float32) * 0.1)
    wp = act_ringconv.pack_weight(k, torch.float32)
    assert wp.shape == (F, 9 * C) and wp.is_contiguous()
    if apply_act:
        s = x * a[:, None, None, :] + b[:, None, None, :]
        s = s * torch.sigmoid(s)
    else:
        s = x
    y = bias.expand(B, H, W, F).clone()
    for h in range(H):
        for kh in range(3):
            row = h + kh - 1
            if not 0 <= row < H:
                continue
            for kw in range(3):
                halo = s[:, row, (torch.arange(W) + kw - 1) % W, :]
                tap = (kh * 3 + kw) * C
                y[:, h] += halo @ wp[:, tap:tap + C].T
    ref = act_ringconv.act_ringconv_plain(x, a, b, k, bias, apply_act=apply_act)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,F", [(8, 16), (24, 72)])
def test_pack_weight_casts_in_the_same_pass(C, F):
    """The default packing (bf16, what the kernel reads) is the fp32 packing
    rounded to bf16, element for element, from a kernel of any dtype."""
    k = t(np.random.default_rng(5).standard_normal((3, 3, C, F), np.float32))
    wp = act_ringconv.pack_weight(k)
    assert wp.dtype == torch.bfloat16 and wp.shape == (F, 9 * C) and wp.is_contiguous()
    torch.testing.assert_close(wp, act_ringconv.pack_weight(k, torch.float32).to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(act_ringconv.pack_weight(k.to(torch.bfloat16)), wp, rtol=0, atol=0)


@pytest.mark.parametrize("B,H,W,C,G", GN_LAUNCH_SHAPES)
def test_gn_launch_args_cover_every_row_once(B, H, W, C, G):
    """Every pixel row of a sample lies in exactly one CTA's share, and
    inside a CTA in exactly one thread row's walk (row0 + r + k*rows_per_pass);
    every channel vector has a thread; the shared memory fits one SM."""
    la = gn_silu._launch_args(B, H, W, C)
    HW = H * W
    assert la.cluster == gn_silu.CLUSTER
    assert la.threads_per_row * 8 == C and la.rows_per_pass >= 1
    assert la.threads_per_row * la.rows_per_pass <= gn_silu.THREADS
    assert la.smem_bytes <= 232_448
    seen = np.zeros(HW, np.int64)
    for rank in range(la.cluster):
        row0 = min(rank * la.rows_per_cta, HW)
        row1 = min(row0 + la.rows_per_cta, HW)
        for r in range(la.rows_per_pass):
            np.add.at(seen, np.arange(row0 + r, row1, la.rows_per_pass), 1)
    np.testing.assert_array_equal(seen, 1)
