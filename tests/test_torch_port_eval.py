"""The port's evaluation path on the CPU, against the JAX package and the
goldens: BEV histograms and metrics, Fréchet distance and feature MMD,
PointNet, RangeNet (blocks, a whole RangeNet-21, RangeNet-53's shapes and
FLOPs, the lidargen indices, the bonnetal names and tar reader), the kNN and
CRF-RNN post-processors, and the entry points ``sample_and_save``,
``evaluate`` and ``completion_demo`` on a tiny checkpoint.

Weights cross between the frameworks through ``utils/weights.py``; inputs
are numpy arrays from a seed."""

import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from r2dm_tpu.checkpoint import save_checkpoint
from r2dm_tpu.metrics import bev as jax_bev
from r2dm_tpu.metrics import distribution as jax_distribution
from r2dm_tpu.metrics.extractor import pointnet as jax_pn
from r2dm_tpu.metrics.extractor import postprocess as jax_pp
from r2dm_tpu.metrics.extractor import rangenet as jax_rn
from r2dm_tpu_torch import completion_demo, evaluate, sample_and_save
from r2dm_tpu_torch import config as port_config
from r2dm_tpu_torch.inference import build_model, model_coords
from r2dm_tpu_torch.metrics import bev, distribution
from r2dm_tpu_torch.metrics.extractor import pointnet as pn
from r2dm_tpu_torch.metrics.extractor import postprocess as pp
from r2dm_tpu_torch.metrics.extractor import rangenet as rn
from r2dm_tpu_torch.utils import weights

# one intra-op thread: the suite runs in several processes at once, and each
# one's default (every core) oversubscribes the machine
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "golden"
# tests/test_metrics.py's tolerances for the goldens
BLOCK_TOL = dict(rtol=1e-3, atol=1e-4)
STEM_TOL = dict(rtol=1e-4, atol=1e-5)
# the same float32 weights and inputs in both frameworks: the sums only
# reassociate
FP32_TOL = dict(rtol=1e-4, atol=1e-5)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def random_bn(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter N(0, 0.1^2) and non-trivial frozen BN statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for m in model.modules():
            if isinstance(m, rn.FrozenBatchNorm):
                n = m.weight.numel()
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model.eval()


# -------------------------------------------------------------------- BEV
def test_bev_histogram_and_metrics_match_golden_and_jax():
    g = np.load(GOLDEN / "metrics_basic.npz")
    hist = bev.point_cloud_to_histogram(t(g["pts"]))
    np.testing.assert_array_equal(hist.numpy(), g["hist"])  # atol 0
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jax_bev.point_cloud_to_histogram(jnp.asarray(g["pts"]))))
    # a batch is one bincount over per-scan offsets, not a loop
    rng = np.random.default_rng(0)
    clouds = (rng.standard_normal((3, 4000, 3)) * 40).astype(np.float32)
    batched = bev.point_cloud_to_histogram(t(clouds)).numpy()
    ref = np.asarray(jax.vmap(jax_bev.point_cloud_to_histogram)(jnp.asarray(clouds)))
    np.testing.assert_array_equal(batched, ref)
    h1, h2 = t(g["hists1"]), t(g["hists2"])
    jsd, mmd = bev.compute_jsd_2d(h1, h2), bev.compute_mmd_2d(h1, h2)
    np.testing.assert_allclose(jsd, float(g["jsd"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mmd, float(g["mmd"]), rtol=1e-4, atol=1e-8)
    # JAX computes in float32, the port in float64
    np.testing.assert_allclose(jsd, jax_bev.compute_jsd_2d(jnp.asarray(g["hists1"]), jnp.asarray(g["hists2"])),
                               rtol=1e-5)
    np.testing.assert_allclose(mmd, jax_bev.compute_mmd_2d(jnp.asarray(g["hists1"]), jnp.asarray(g["hists2"])),
                               rtol=1e-4)


def test_cdist_rbf_never_builds_the_difference_tensor():
    """At N = 256, M = 128 and 10,000 bins the (N, M, bins) float32
    difference would take 1.31 GB; no allocation of cdist_rbf may pass a
    64 MB budget. Held against the difference form, a block of 4 rows at a
    time in float64."""
    N, M, D = 256, 128, 100 * 100
    budget = 64 * 2**20
    rng = np.random.default_rng(1)
    p = rng.uniform(size=(N, D)).astype(np.float32)
    q = rng.uniform(size=(M, D)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    q /= q.sum(1, keepdims=True)
    assert N * M * D * 4 > 16 * budget
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], profile_memory=True) as prof:
        k = bev.cdist_rbf(t(p), t(q))
    biggest = max(e.cpu_memory_usage for e in prof.events())
    assert 0 < biggest <= budget, biggest
    ref = np.concatenate([np.exp(-2.0 * np.square(p[i:i + 4, None].astype(np.float64) - q[None]).sum(-1))
                          for i in range(0, N, 4)])
    np.testing.assert_allclose(k.numpy(), ref, rtol=1e-12, atol=0)


# ------------------------------------------------------------ distribution
def test_distribution_metrics_match_golden_and_jax():
    """The Fréchet distance's eigen form against the golden (rtol 1e-6, as
    tests/test_metrics.py) and against the JAX package's scipy sqrtm (rtol
    1e-12 at full rank; 1e-6 with singular covariances, 8 samples of 64
    features, where the eigen form is also finite)."""
    g = np.load(GOLDEN / "metrics_basic.npz")
    fd = distribution.compute_frechet_distance(g["feats1"], g["feats2"])
    np.testing.assert_allclose(fd, float(g["fd"]), rtol=1e-6)
    np.testing.assert_allclose(fd, jax_distribution.compute_frechet_distance(g["feats1"], g["feats2"]), rtol=1e-12)
    rng = np.random.default_rng(7)
    f1, f2 = rng.standard_normal((8, 64)), rng.standard_normal((8, 64)) * 1.5 + 0.2
    fd = distribution.compute_frechet_distance(f1, f2)
    assert np.isfinite(fd)
    np.testing.assert_allclose(fd, jax_distribution.compute_frechet_distance(f1, f2), rtol=1e-6)
    np.random.seed(123)  # the reference draws from numpy's global state
    smmd = distribution.compute_squared_mmd(g["feats1"], g["feats2"], num_subsets=10, max_subset_size=32)
    np.testing.assert_allclose(smmd, float(g["smmd_seed123"]), rtol=1e-6)
    a = distribution.compute_squared_mmd(g["feats1"], g["feats2"], num_subsets=10, max_subset_size=32, seed=5)
    assert a == jax_distribution.compute_squared_mmd(g["feats1"], g["feats2"], num_subsets=10,
                                                      max_subset_size=32, seed=5)


# --------------------------------------------------------------- PointNet
def test_pointnet_matches_golden_and_jax():
    """The golden's float16 weights: rtol = atol = 2e-2 (tests/test_metrics.py);
    the same float32 weights in both frameworks: FP32_TOL."""
    g = np.load(GOLDEN / "pointnet.npz")
    sd = {k[4:]: t(g[k]) for k in g.files if k.startswith("sd::")}
    model = pn.PointNet1(k=16)
    model.load_state_dict(sd)
    with torch.no_grad():
        feats = model(t(g["pts"]))  # (B, 3, N), the reference layout
    assert feats.shape == (2, 1808)
    np.testing.assert_allclose(feats.numpy(), g["feats"], rtol=2e-2, atol=2e-2)

    # random float32 weights with non-trivial BN statistics, carried to
    # flax by the JAX package's own converter and back by the port's
    src = random_bn(pn.PointNet1(k=16), 4).state_dict()
    params = jax_pn.convert_pointnet_state_dict({k: v.numpy() for k, v in src.items()})
    back = weights.pointnet_state_dict_from_flax(params)
    assert back.keys() == src.keys() and all(torch.equal(back[k], src[k]) for k in src)
    model.load_state_dict(back)
    pts = np.random.default_rng(4).standard_normal((2, 3, 700)).astype(np.float32)
    with torch.no_grad():
        ours = model(t(pts)).numpy()
    ref = jax.jit(jax_pn.PointNet1(k=16).apply)({"params": params}, jnp.asarray(pts.transpose(0, 2, 1)))
    np.testing.assert_allclose(ours, np.asarray(ref), **FP32_TOL)


def test_pretrained_pointnet_reads_a_sparenet_pth(tmp_path):
    """A SpareNet-layout state dict, ``num_batches_tracked`` included."""
    src = random_bn(pn.PointNet1(k=16), 5)
    sd = dict(src.state_dict())
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(39)
    torch.save(sd, tmp_path / "cls_model_39.pth")
    model = pn.pretrained_pointnet(str(tmp_path / "cls_model_39.pth"), device="cpu")
    x = t(np.random.default_rng(6).standard_normal((1, 3, 64)))
    with torch.no_grad():
        assert torch.equal(model(x), src(x))


# --------------------------------------------------------------- RangeNet
def test_rangenet_blocks_and_preprocess_match_golden():
    g = np.load(GOLDEN / "rangenet_blocks.npz")

    def sd_of(tag):
        p = f"sd_{tag}::"
        return {k[len(p):]: t(g[k]) for k in g.files if k.startswith(p)}

    x = t(g["x"])
    for tag, module, out, tol in (("stem", rn.conv_bn_lrelu(8, 16), "stem_out", STEM_TOL),
                                  ("down", rn.Block(8, 16, 2, "down"), "down_out", BLOCK_TOL),
                                  ("up", rn.Block(8, 4, 1, "up"), "up_out", BLOCK_TOL)):
        module.load_state_dict(sd_of(tag))  # the reference torch names, strict
        with torch.no_grad():
            np.testing.assert_allclose(module(x).numpy(), g[out], err_msg=tag, **tol)
    np.testing.assert_allclose(rn.preprocess(t(g["pre_in"])).numpy(), g["pre_out"], rtol=1e-5, atol=1e-6)
    mask = t(np.random.default_rng(0).uniform(size=(2, 1, 4, 64)) > 0.3)
    ours = rn.preprocess(t(g["pre_in"]), mask).numpy()
    ref = jax_rn.preprocess(jnp.asarray(nhwc(g["pre_in"])), jnp.asarray(nhwc(mask.numpy())))
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def rangenet21_tar(tmp_path_factory):
    """A bonnetal-layout darknet21.tar.gz of random weights with non-trivial
    BN statistics, written by the port."""
    model = random_bn(rn.RangeNet(backbone=21), 0)
    path = tmp_path_factory.mktemp("bonnetal") / "darknet21.tar.gz"
    rn.save_rangenet_tar(str(path), model)
    return str(path), model


def test_rangenet21_from_one_tar_matches_jax(rangenet21_tar):
    """Both packages read the same tar; the whole net at (2, 5, 4, 64): the
    logits, the decoder's map and the lidargen features (the decoder blocks
    run the transposed conv, whose flip a shape test would not see)."""
    path, src = rangenet21_tar
    sd, cfg, (mean, std) = rn.load_rangenet_tar(path)
    variables, jcfg, (jmean, jstd) = jax_rn.load_rangenet_tar(path)
    assert cfg == jcfg == {"in_channels": 5, "num_classes": 20, "backbone": 21}
    assert (list(mean), list(std)) == (list(jmean), list(jstd)) == (list(rn.IMG_MEANS), list(rn.IMG_STDS))
    src_sd = src.state_dict()
    assert sd.keys() == src_sd.keys() and all(torch.equal(sd[k], src_sd[k]) for k in sd)
    from_flax = weights.rangenet_state_dict_from_flax(jax.tree.map(np.asarray, variables))
    assert from_flax.keys() == sd.keys() and all(torch.equal(from_flax[k], sd[k]) for k in sd)

    model, pre = rn.rangenet21(path, device="cpu")
    rng = np.random.default_rng(2)
    img = (rng.standard_normal((2, 5, 4, 64)) * 5).astype(np.float32)
    with torch.no_grad():
        x = pre(t(img))
        logits, dec, feats = model(x), model(x, "decoder"), model(x, "lidargen")
    jm = jax_rn.RangeNet(**jcfg)
    apply = jax.jit(jm.apply, static_argnames="feature")
    jx = jax_rn.preprocess(jnp.asarray(nhwc(img)), mean=jmean, std=jstd)
    np.testing.assert_allclose(nhwc(x), np.asarray(jx), rtol=1e-6, atol=1e-6)
    jdec = apply(variables, jx, feature="decoder")
    for name, ours, ref in (("logits", logits, apply(variables, jx)), ("decoder", dec, jdec)):
        scale = float(np.abs(np.asarray(ref)).max())
        np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=FP32_TOL["rtol"], atol=1e-5 * scale,
                                   err_msg=name)
    ref_feats = np.asarray(jax_rn.flatten_and_subsample(jdec))
    assert feats.shape == (2, 4096)
    np.testing.assert_allclose(feats.numpy(), ref_feats, rtol=FP32_TOL["rtol"],
                               atol=1e-5 * float(np.abs(ref_feats).max()))
    with pytest.raises(ValueError, match="darknet21, not darknet53"):
        rn.rangenet53(path, device="cpu")


def test_rangenet53_shapes_and_flops_match_jax():
    """RangeNet-53 at 64x1024 on the meta device (nothing is computed): the
    output shapes, every parameter shape against the JAX package's
    (jax.eval_shape, no compile), and 359.7 GFLOP an image."""
    model = rn.RangeNet(backbone=53).to("meta")
    x = torch.empty((1, 5, 64, 1024), device="meta")
    with torch.no_grad():
        assert model(x).shape == (1, 20, 64, 1024)
        assert model(x, "decoder").shape == (1, 32, 64, 1024)
        assert model(x, "lidargen").shape == (1, 4096)
    shapes = jax.eval_shape(jax_rn.RangeNet(backbone=53).init, jax.random.key(0), jnp.zeros((1, 64, 1024, 5)))
    ref = weights.rangenet_state_dict_from_flax(
        jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in ref.items()}
    assert sum(p.numel() for p in model.parameters()) == 50_333_716
    assert rn.forward_flops(model, 64, 1024) == 359_707_705_344


def test_subsample_indices_match_jax_and_leave_random_alone():
    state = random.getstate()
    ours = rn.subsample_indices(32, 64, 1024)
    assert random.getstate() == state
    np.testing.assert_array_equal(ours, jax_rn.subsample_indices(32, 64, 1024))
    assert len(np.unique(ours)) == 4096
    fmaps = torch.arange(2 * 32 * 4 * 64, dtype=torch.float32).reshape(2, 32, 4, 64)
    np.testing.assert_array_equal(rn.flatten_and_subsample(fmaps.contiguous(memory_format=torch.channels_last)),
                                  np.asarray(jax_rn.flatten_and_subsample(jnp.asarray(nhwc(fmaps.numpy())))))


def test_bonnetal_names_agree_with_translate_bonnetal_key(rangenet21_tar):
    """Every bonnetal key of a RangeNet: the port's mapping and the JAX
    package's translate_bonnetal_key + convert_rangenet_state_dict give the
    same tensors; the inverse mapping round-trips; the cases of
    tests/test_metrics.py land where the port's names say."""
    _, model = rangenet21_tar
    sd = model.state_dict()
    bonn = weights.bonnetal_from_rangenet_state_dict(sd)
    assert {k.split(".")[1] for k in bonn if k.startswith("enc")} >= {"conv", "bn", "residual_0", "residual_1"}
    assert {k.split(".")[1] for k in bonn if k.startswith("dec")} == {"upconv", "bn", "residual"}
    assert all(jax_rn.translate_bonnetal_key(k) is not None for k in bonn)
    back = weights.rangenet_state_dict_from_bonnetal({**bonn, "enc1.bn.num_batches_tracked": torch.tensor(1)})
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    via_jax = weights.rangenet_state_dict_from_flax(
        jax_rn.convert_rangenet_state_dict({k: v.numpy() for k, v in bonn.items()}))
    assert via_jax.keys() == sd.keys() and all(torch.equal(via_jax[k], sd[k]) for k in sd)
    cases = {
        "conv1.weight": "stem.0.weight", "bn1.running_mean": "stem.1.running_mean",
        "enc1.conv.weight": "enc1.conv.0.weight", "enc1.bn.weight": "enc1.conv.1.weight",
        "enc3.residual.conv1.weight": "enc3.residual_blocks.0.residual.0.0.weight",
        "enc3.residual_2.bn2.running_var": "enc3.residual_blocks.2.residual.1.1.running_var",
        "dec5.upconv.weight": "dec5.conv.0.weight", "dec5.upconv.bias": "dec5.conv.0.bias",
        "dec5.bn.bias": "dec5.conv.1.bias", "1.weight": "head.weight",
    }
    assert weights.rangenet_state_dict_from_bonnetal({k: torch.zeros(1) for k in cases}).keys() == set(cases.values())
    with pytest.raises(KeyError, match="unrecognized bonnetal key"):
        weights.rangenet_state_dict_from_bonnetal({"enc1.dropout.weight": torch.zeros(1)})


ARCH_CFG = """\
################################################################################
# training parameters
################################################################################
train:
  loss: "xentropy"       # must be either xentropy or iou
  max_epochs: 150
  lr: 0.01              # sgd learning rate
  wup_epochs: 1         # warmup during first XX epochs (can be float)
  momentum: 0.9          # sgd momentum
  save_summary: False   # Summary of weight histograms for tensorboard
  show_scans: False     # false for webserver
################################################################################
# backbone parameters
################################################################################
backbone:
  name: "darknet"  # ['squeezeseg', 'squeezesegV2', 'darknet']
  input_depth:
    range: True
    xyz: True
    remission: True
  dropout: 0.01
  bn_d: 0.01
  OS: 32 # output stride (only horizontally)
  train: True # train backbone?
  extra:
    layers: 53
decoder:
  name: "darknet"
  extra: False # nothing to add for this decoder, otherwise this is a dict
post:
  CRF:
    use: False
    params: False # this should be a dict when in use
  KNN:
    use: False
    params:
      knn: 5
      sigma: 1.0
dataset:
  labels: "kitti"
  max_points: 150000 # max of any scan in dataset
  sensor:
    name: "HDL64"
    type: "spherical" # projective
    fov_up: 3
    fov_down: -25
    img_prop:
      width: 2048
      height: 64
    img_means: #range,x,y,z,signal
      - 12.12
      - 10.88
      - 0.23
      - -1.04
      - 0.21
    img_stds: #range,x,y,z,signal
    - 12.32
    - 11.47
    - 6.91
    - 0.86
    - 0.16
    flow: [1, 2.5, 'a#b']
"""


def test_arch_cfg_reader_matches_yaml():
    assert rn.read_arch_cfg(ARCH_CFG) == yaml.safe_load(ARCH_CFG)
    with pytest.raises(ValueError, match="cannot read"):
        rn.read_arch_cfg("a:\n  b: 1\n c\n")


# -------------------------------------------------------- post-processors
def test_knn_and_crf_match_golden_and_jax():
    g = np.load(GOLDEN / "postprocessors.npz")
    refined = pp.knn_filter(t(g["depth"]), torch.from_numpy(g["label"]), num_classes=6).numpy()
    # ties in distance or vote may break differently between torch.topk and
    # lax.top_k: near-total agreement (tests/test_metrics.py)
    assert (refined == g["knn_refined"]).mean() > 0.99
    ref = jax_pp.knn_filter(jnp.asarray(nhwc(g["depth"])), jnp.asarray(g["label"]), num_classes=6)
    assert (refined == np.asarray(ref)).mean() > 0.99
    out = pp.CRFRNN(num_classes=6)(t(g["unary"]), t(g["xyz"]), t(g["mask"])).numpy()
    np.testing.assert_allclose(out, g["crf_out"], rtol=1e-4, atol=1e-5)
    ref = jax_pp.CRFRNN(num_classes=6)(jnp.asarray(nhwc(g["unary"])), jnp.asarray(nhwc(g["xyz"])),
                                      jnp.asarray(g["mask"]))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------- entry points
@pytest.fixture(scope="module")
def tiny_msgpack(tmp_path_factory):
    """A JAX-package msgpack checkpoint of a tiny net at 16x128 on the
    synthetic set, written by the JAX package from the port's random
    weights (no JAX compile)."""
    cfg = port_config.Config(
        data=port_config.DataConfig(dataset="synthetic", resolution=(16, 128), projection="spherical-256"),
        model=port_config.ModelConfig(base_channels=8, channel_multiplier=(1, 2, 2, 2),
                                      num_residual_blocks=(1, 1, 1, 1), gn_num_groups=4, attn_num_heads=2),
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu")
    model.coords.copy_(t(model_coords(cfg).transpose(2, 0, 1)[None]))
    variables = weights.jax_from_state_dict(model.state_dict())
    path = tmp_path_factory.mktemp("ckpt") / "tiny.msgpack"
    save_checkpoint(str(path), port_config.asdict(cfg), variables, ema_weights=variables, step=1)
    return str(path)


def _load_repo_evaluate():
    import importlib.util

    spec = importlib.util.spec_from_file_location("repo_evaluate", REPO / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sample_and_save_then_evaluate(tiny_msgpack, tmp_path, monkeypatch, capsys):
    """sample_and_save -> evaluate -> JSON with random extractors at 16x128:
    the port's sample files read by the JAX package's evaluate.load_sample,
    the real-set cache under the port's own name, and a second run from the
    cache with the same JSON. 256 lidargen features instead of 4096 keep
    the host's eigendecompositions of their covariance short (the 4096 are
    held against JAX in test_rangenet21_from_one_tar_matches_jax)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "4")
    monkeypatch.setattr(rn, "NUM_FEATURES", 256)
    out = tmp_path / "samples"
    args = sample_and_save.parse_args(["--ckpt", tiny_msgpack, "--output_dir", str(out), "--batch_size", "3",
                                       "--num_samples", "5", "--num_steps", "2", "--device", "cpu"])
    assert sample_and_save.main(args) == 0
    files = sorted(out.glob("*.npz"))
    assert [f.name for f in files] == [f"samples_{i:010d}.npz" for i in range(5)]
    repo_load = _load_repo_evaluate().load_sample
    for f in files:
        s = repo_load(f)
        assert s.shape == (5, 16, 128) and np.isfinite(s).all() and s.dtype == np.float32
        np.testing.assert_array_equal(evaluate.load_sample(f), s)
    # a reference .pth sample reads the same
    torch.save(torch.from_numpy(repo_load(files[0])), tmp_path / "s.pth")
    np.testing.assert_array_equal(evaluate.load_sample(tmp_path / "s.pth"), repo_load(files[0]))

    argv = ["--ckpt", tiny_msgpack, "--sample_dir", str(out), "--batch_size", "3", "--allow_random_extractors",
            "--device", "cpu"]
    assert evaluate.main(evaluate.parse_args(argv)) == 0
    first = sorted(tmp_path.glob("samples_*.json"))
    assert len(first) == 1
    results = json.loads(first[0].read_text())
    first[0].rename(tmp_path / "first.json")
    for section in ("img", "pts", "bev"):
        assert results[section] and all(np.isfinite(v) for v in results[section].values()), section
    assert (results["info"]["#real"], results["info"]["#fake"]) == (4, 5)
    cache = sorted(p.name for p in tmp_path.glob("real_set_*"))
    assert cache == ["real_set_torch_synthetic-4_spherical-256_16x128_all_randomRN-randomPN.npz"]
    capsys.readouterr()
    assert evaluate.main(evaluate.parse_args(argv)) == 0
    assert "found cached real_set_torch_" in capsys.readouterr().out
    assert json.loads(next(tmp_path.glob("samples_*.json")).read_text()) == results
    with pytest.raises(SystemExit, match="need --rangenet_tar"):
        evaluate.main(evaluate.parse_args(argv[:6] + ["--device", "cpu"]))


def test_completion_demo_writes_its_figure(tiny_msgpack, tmp_path, monkeypatch):
    """The four masks, a 2 x 2 x 1 RePaint grid and the semantic labels (a
    RangeNet-21 stands in for RangeNet-53), then the grid of panels."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "3")
    net = random_bn(rn.RangeNet(backbone=21), 1)
    monkeypatch.setattr(completion_demo.rn, "rangenet53", lambda tar, device: (net, rn.preprocess))
    for tar, rows in ((None, 2 * 16 + 800 + 2 * 16 + 800), ("unused.tar.gz", 2 * 16 + 800 + 2 * 16 + 16 + 800)):
        argv = ["--ckpt", tiny_msgpack, "--num_steps", "2", "--num_resample_steps", "2", "--device", "cpu"] + (
            ["--rangenet_tar", tar] if tar else [])
        assert completion_demo.main(completion_demo.parse_args(argv)) == 0
        png = tmp_path / "completion_T-0002_r-0002_j-0001.png"
        head = png.read_bytes()[:24]
        height, width = int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")
        panels = 5 if tar else 4
        assert (height, width) == (rows + 4 * panels, 4 * 800 + 3 * 8)
    masks = completion_demo.make_masks(np.random.default_rng(0), 16, 128)
    assert masks[0].all() and masks[1, ::4].all() and not masks[1, 1::4].any()
    preset = completion_demo.apply_few_step_preset(completion_demo.parse_args(["--ckpt", "x", "--few_step"]))
    # JAX's preset (completion_demo.py:25-36), the W2C layout included
    assert (preset.num_steps, preset.num_resample_steps, preset.bf16, preset.latency_layout) == (8, 4, True, True)


@pytest.mark.parametrize("module,argv", [
    ("completion_demo", ["--latency_layout"]),
])
def test_unported_flags_exit_with_their_roadmap_item(tiny_msgpack, module, argv, tmp_path, monkeypatch):
    """The flags that exited before their ROADMAP item was ported now run:
    ``completion_demo --latency_layout`` builds its network with
    ``width_merge_l1=True`` and writes its figure."""
    mod = {"completion_demo": completion_demo}[module]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("R2DM_SYNTH_SCANS", "3")
    seen, real = [], mod.setup_model

    def recording(*a, **kw):
        seen.append(kw.get("width_merge_l1"))
        return real(*a, **kw)

    monkeypatch.setattr(mod, "setup_model", recording)
    run = ["--num_steps", "2", "--num_resample_steps", "1", "--device", "cpu"]
    assert mod.main(mod.parse_args(["--ckpt", tiny_msgpack, *run, *argv])) == 0
    assert seen == [True] and (tmp_path / "completion_T-0002_r-0001_j-0001.png").exists()
