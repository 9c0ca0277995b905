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

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)


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


@pytest.mark.parametrize("tile", list(act_ringconv.TILES))
@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("B,H,W,C,F", [(2, 3, 20, 16, 24), (1, 1, 8, 8, 8), (3, 2, 12, 24, 72),
                                       (1, 2, 10, 40, 136)])
def test_packed_weight_implicit_gemm_matches_plain(B, H, W, C, F, apply_act, tile):
    """The conv rebuilt as the CUDA kernel computes it, in fp32, from the
    weight packed for each tile variant: for each output row h and kernel
    row kh whose input row lies inside [0, H) (rows in the H padding are
    skipped), each channel slice and tap kw multiplies the ring-wrapped halo
    (W index taken mod W) by its [BK/8][BN][8] block of the packed slice,
    channels past C and outputs past F padded with zeros."""
    rng = np.random.default_rng(4)
    x = t(rng.standard_normal((B, H, W, C), np.float32))
    a = t(rng.standard_normal((B, C), np.float32) * 0.5 + 1.0)
    b = t(rng.standard_normal((B, C), np.float32) * 0.5 + 2.0)  # silu(b) far from 0
    k = t(rng.standard_normal((3, 3, C, F), np.float32) * 0.1)
    bias = t(rng.standard_normal((F,), np.float32) * 0.1)
    _, bn, bk = act_ringconv.TILES[tile]
    n_t, n_c = -(-F // bn), -(-C // bk)
    wp = act_ringconv.pack_weight(k, tile, torch.float32)
    assert wp.shape == (n_t, 3, n_c, 3, bk // 8, bn, 8) and wp.is_contiguous()
    if apply_act:
        s = x * a[:, None, None, :] + b[:, None, None, :]
        s = s * torch.sigmoid(s)
    else:
        s = x
    s = torch.nn.functional.pad(s, (0, n_c * bk - C))  # the kernel's zero-filled channels
    y = torch.zeros(B, H, W, n_t * bn)
    for h in range(H):
        for kh in range(3):
            row = h + kh - 1
            if not 0 <= row < H:
                continue
            for kw in range(3):
                halo = s[:, row, (torch.arange(W) + kw - 1) % W, :]
                for nt in range(n_t):
                    for cs in range(n_c):
                        block = wp[nt, kh, cs, kw].permute(0, 2, 1).reshape(bk, bn)  # (c, n)
                        y[:, h, :, nt * bn:(nt + 1) * bn] += halo[..., cs * bk:(cs + 1) * bk] @ block
    y = y[..., :F] + bias
    ref = act_ringconv.act_ringconv_plain(x, a, b, k, bias, apply_act=apply_act)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    assert not wp[n_t - 1, ..., F - (n_t - 1) * bn:, :].any()  # outputs past F are zero


@pytest.mark.parametrize("C,F", [(8, 16), (24, 72)])
def test_pack_weight_casts_in_the_same_pass(C, F):
    """The default packing (bf16, what the kernel reads) is the fp32 packing
    rounded to bf16, element for element, from a kernel of any dtype and
    from a strided view (a parameter's ``hwio()`` permute), for every tile
    variant."""
    k = t(np.random.default_rng(5).standard_normal((3, 3, C, F), np.float32))
    strided = k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)  # OIHW storage seen as HWIO
    for tile in act_ringconv.TILES:
        wp = act_ringconv.pack_weight(k, tile)
        assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
        torch.testing.assert_close(wp, act_ringconv.pack_weight(k, tile, torch.float32).to(torch.bfloat16),
                                   rtol=0, atol=0)
        torch.testing.assert_close(act_ringconv.pack_weight(k.to(torch.bfloat16), tile), wp, rtol=0, atol=0)
        torch.testing.assert_close(act_ringconv.pack_weight(strided, tile), wp, rtol=0, atol=0)


def _conv_shapes():
    """(C_in, F, H, W) -> launches a forward of every config-H ResidualBlock
    conv, and of its input gradient (C_in and F swapped) in a train step."""
    return _chip_smoke().CONV_SHAPES


H100_SMS = 132  # an H100 SXM's SMs, the card the rule is measured on


# the rule's choice at config H: (C_in, F, H, W) -> (tile at b8, at b256)
CONFIG_H_TILES = {
    (64, 64, 64, 1024): ("m256n64", "m256n64"),
    (128, 64, 64, 1024): ("m256n64", "m256n64"),
    (128, 128, 32, 512): ("m128n128", "m128n128"),
    (256, 64, 32, 512): ("m256n64", "m256n64"),
    (64, 64, 32, 512): ("m256n64", "m256n64"),
    (256, 256, 16, 256): ("m128n256", "m128n256"),
    (512, 128, 16, 256): ("m128n128", "m128n128"),
    (128, 128, 16, 256): ("m128n128", "m128n128"),
    (512, 512, 8, 128): ("m128n128", "m128n256"),
    (512, 256, 8, 128): ("m128n128", "m128n256"),
    (256, 256, 8, 128): ("m128n128", "m128n256"),
}


@pytest.mark.parametrize("B", [8, 256])
@pytest.mark.parametrize("shape", list(CONFIG_H_TILES))
@pytest.mark.parametrize("grad", [False, True])
def test_tile_rule_fills_the_card_at_config_h(shape, B, grad):
    """At every config-H ResidualBlock shape (and its input gradient's, C_in
    and F swapped), at b8 and b256: the chosen variant's N tile covers F in
    whole tiles (no masked channels on the main path) and its pixel tile
    divides W; a 256-channel tile is taken only where it gives every SM a
    tile, and otherwise the 128-channel one, whose grid falls short of a
    wave at two b8 shapes of level 4 (128 tiles of 132): measured there,
    it beats 64-channel tiles that fill the card (PERF.md, PR 19)."""
    C, F, H, W = shape
    if grad:
        C, F = F, C
    tile = act_ringconv.tile_variant(B, H, W, C, F, H100_SMS)
    bm, bn, _ = act_ringconv.TILES[tile]
    tiles = act_ringconv.tile_count(tile, B, H, W, F)
    assert F % bn == 0 and W % bm == 0
    assert bn == 64 if F == 64 else bn >= 128
    wide = act_ringconv.tile_count("m128n256", B, H, W, F)
    assert (bn == 256) == (F > 128 and wide >= H100_SMS)
    assert tiles >= H100_SMS or (tile == "m128n128" and tiles >= 128)
    if not grad:
        assert tile == CONFIG_H_TILES[shape][B == 256]


@pytest.mark.parametrize("B", [8, 256])
def test_tile_rule_splits_a_forward(B):
    """The 48 ResidualBlock convs of a config-H forward, split over the tile
    variants as the rule predicts (chip_smoke.py checks the card's counters
    against this split)."""
    split = dict.fromkeys(act_ringconv.TILES, 0)
    for (C, F, H, W), count in _conv_shapes().items():
        split[act_ringconv.tile_variant(B, H, W, C, F, H100_SMS)] += count
    assert sum(split.values()) == 48
    expected = ({"m256n64": 18, "m128n128": 24, "m128n256": 6} if B == 8 else
                {"m256n64": 18, "m128n128": 12, "m128n256": 18})
    assert split == expected


def test_tile_variant_is_chosen_once_per_shape(monkeypatch):
    """The choice is cached per shape (and SM count): the second call is a
    dictionary lookup, and never runs the rule again."""
    monkeypatch.setattr(act_ringconv, "_tiles", {})
    first = act_ringconv.tile_variant(8, 64, 1024, 64, 64, H100_SMS)
    monkeypatch.setattr(act_ringconv, "_choose_tile", lambda *a: pytest.fail("the rule ran again"))
    assert act_ringconv.tile_variant(8, 64, 1024, 64, 64, H100_SMS) == first == "m256n64"
    assert act_ringconv._tiles == {(8, 64, 1024, 64, 64, H100_SMS): first}


@pytest.mark.parametrize("B,H,W,C,F", [(1, 1, 8, 8, 8), (1, 3, 40, 16, 24), (2, 2, 200, 72, 24),
                                       (1, 2, 256, 64, 128), (1, 1, 40, 24, 72)])
def test_tile_rule_takes_the_most_tiles_of_a_small_shape(B, H, W, C, F):
    """Where no variant gives a wave of tiles, the rule takes, of the
    variants its F allows (64 channels at F <= 64, else 128 or 256), the
    one with the most tiles."""
    tile = act_ringconv.tile_variant(B, H, W, C, F, H100_SMS)
    allowed = ["m256n64"] if F <= 64 else ["m128n128", "m128n256"]
    assert tile in allowed
    assert all(act_ringconv.tile_count(tile, B, H, W, F) >= act_ringconv.tile_count(o, B, H, W, F)
               for o in allowed)


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
