"""Port parity of the model variants' modules against the JAX package, on the CPU.

The pieces the registry's other agents add to the DiffusionDrive model:
the diffusion-policy head (`ConditionalUnet1D`, `UnetTrajectoryHead`,
`rollout_timesteps`), the Transfuser baseline's `MLPTrajectoryHead`, the
ResNet-50 `Bottleneck` and features of the nuScenes variant, its k-means
plan anchors (`default_plan_anchors(20, 6)`, `make_plan_anchors`), and the
converter's strictness on each new tree. The UNet head's rollout and
training forward are in `test_torch_port_variants_unet.py`, whole models
and their train steps in `test_torch_port_variants_model.py` and
`test_torch_port_variants_nuscenes.py` (split so that `--dist loadfile`
spreads them over the workers).

JAX variables are not made by a jitted `init` (~15 s a model on a
CPU): `seeded_variables` traces `init` abstractly and fills each leaf from
numpy. Tolerances: float32 as `test_torch_port_model.py` (atol 2e-4, rtol
1e-4); float64 runs under `jax.enable_x64` and holds 1e-6: the UNet's
timestep embedding is float32 in both packages, and float32 sin and cos
differ by an ulp (6e-8) between XLA and torch in some of its elements;
all that follows is float64, where sums in another order agree to ~1e-15
relative an op. The anchors are numpy with fixed seeds on both sides and
must be equal bit for bit.
"""

import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.models import conditional_unet1d as junet
from diffusiondrive_tpu.models import resnet as jresnet
from diffusiondrive_tpu.models.config import TransfuserConfig as JConfig
from diffusiondrive_tpu.models.diffusion_head import default_plan_anchors as j_default_plan_anchors
from diffusiondrive_tpu.models.transfuser_model import MLPTrajectoryHead as JMLPHead
from diffusiondrive_tpu.ops.ddim import DDIMScheduler as JScheduler

from diffusiondrive_torch.models.conditional_unet1d import ConditionalUnet1D
from diffusiondrive_torch.models.diffusion_head import default_plan_anchors
from diffusiondrive_torch.models.resnet import Bottleneck, ResNetStage, ResNetStem
from diffusiondrive_torch.models.transfuser_model import MLPTrajectoryHead
from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
from diffusiondrive_torch.ops.ddim import DDIMScheduler
from diffusiondrive_torch.utils.port_jax import jax_to_state_dict, load_jax_variables

from test_torch_port_model import _port_config

ATOL, RTOL = 2e-4, 1e-4          # float32, as tests/test_torch_port_model.py
ATOL64, RTOL64 = 1e-6, 1e-6      # float64 behind a float32 timestep embedding
DOWN_DIMS = (16, 32, 64)         # tests/test_unet1d_torch_parity.py


def seeded_variables(module, *args, seed: int = 0, constants=None, **kwargs):
    """Flax variables of `module` for `args` without a compiled `init`: the
    tree's shapes from an abstract trace, each leaf drawn from numpy near
    the Flax initialisers' scales (kernels ~ N(0, 1/fan_in), those of the
    GPT fusion blocks and the position embeddings ~ N(0, 0.02) as JAX
    draws them, so that the fusion attention is as soft as at JAX's init;
    biases ~ N(0, 0.02), norm scales ~ U(0.5, 1.5), the other free
    embeddings ~ N(0, 1), BN means ~ N(0, 0.3) and variances ~ U(0.7,
    1.5)); `constants` fills the constants collection."""
    rngs = {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: module.init(rngs, *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [p.key for p in path]
        shape, name = leaf.shape, keys[-1]
        if keys[0] == "constants":
            return np.asarray(constants[name], np.float32)
        if keys[0] == "batch_stats":
            a = rng.normal(0, 0.3, shape) if name == "mean" else rng.uniform(0.7, 1.5, shape)
        elif name == "kernel" and not any(k.startswith("fusion") for k in keys):
            a = rng.normal(0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("kernel", "pos_emb", "bias"):
            a = rng.normal(0, 0.02, shape)
        elif name == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0, 1.0, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _close(got, want, dtype=torch.float32, name=""):
    atol, rtol = (ATOL64, RTOL64) if dtype == torch.float64 else (ATOL, RTOL)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=atol, rtol=rtol,
                               err_msg=name)


# --------------------------------------------------------------------------- #
# the schedule and the anchors
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("steps", [1, 2, 4, 10, 20, 50, 1000])
def test_rollout_timesteps_match_jax(steps):
    got = DDIMScheduler().rollout_timesteps(steps)
    assert got == JScheduler().rollout_timesteps(steps)
    assert len(got) == steps and got[-1] == 0
    if steps == 20:
        assert got[0] == 950 and all(a - b == 50 for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("modes,poses", [(20, 6), (20, 8)])
def test_default_plan_anchors_equal_jax_bit_for_bit(modes, poses):
    """(20, 8) is the shipped asset; any other shape is k-means over the
    synthetic rollouts, numpy on both sides."""
    got, want = default_plan_anchors(modes, poses), j_default_plan_anchors(modes, poses)
    assert got.shape == want.shape == (modes, poses, 2) and got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_make_plan_anchors_matches_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs over one cache (written by the port's `write_example_cache`
    at 6 poses) write the same .npy bytes."""
    from diffusiondrive_tpu.script import make_plan_anchors as jcli
    from diffusiondrive_torch.common.dataclasses import TrajectorySampling
    from diffusiondrive_torch.entry import write_example_cache
    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.script import make_plan_anchors as pcli

    from test_train import CAM_H, CAM_W, LID

    cfg = TransfuserConfig(camera_height=CAM_H // 2, camera_width=CAM_W // 2, lidar_resolution_height=LID // 2,
                           lidar_resolution_width=LID // 2, bev_pixel_height=8, bev_pixel_width=16,
                           trajectory_sampling=TrajectorySampling(time_horizon=3, interval_length=0.5))
    cache = write_example_cache(tmp_path / "cache", cfg, 12, seed=3)
    args = ["--cache-path", str(cache), "--num-modes", "4", "--num-poses", "6", "--num-iters", "20", "--seed", "2"]
    monkeypatch.setattr(sys, "argv", ["make_plan_anchors", *args, "--out", str(tmp_path / "jax.npy")])
    jcli.main()
    pcli.main([*args, "--out", str(tmp_path / "port.npy")])
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == (4, 6, 2)
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    with pytest.raises(SystemExit):
        pcli.main(["--out", str(tmp_path / "none.npy"), "--navsim-log-path", ""])


# --------------------------------------------------------------------------- #
# the diffusion-policy UNet and its head
# --------------------------------------------------------------------------- #

def _unet_inputs(B=2, L=8, cond_dim=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, 3)).astype(np.float32), np.array([7, 423][:B], np.int32),
            rng.normal(size=(B, cond_dim)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_conditional_unet1d_matches_jax_elementwise(dtype):
    """`ConditionalUnet1D` at down dims (16, 32, 64): every output element,
    in float32 and in float64 (`jax.enable_x64`, the Flax module at
    dtype float64). The Flax tree crosses over strictly, so every Conv1d,
    ConvTranspose1d (taps reversed), GroupNorm and Dense is filled."""
    sample, t, cond = _unet_inputs()
    kw = dict(input_dim=3, global_cond_dim=24, diffusion_step_embed_dim=32, down_dims=DOWN_DIMS)
    variables = seeded_variables(junet.ConditionalUnet1D(**kw), sample, t, cond, seed=1)
    port = load_jax_variables(ConditionalUnet1D(**kw, dtype=dtype), variables).to(dtype)
    with torch.no_grad():
        got = port(torch.from_numpy(sample).to(dtype), torch.from_numpy(t).long(),
                   torch.from_numpy(cond).to(dtype)).numpy()
    if dtype == torch.float64:
        with jax.enable_x64(True):
            m = junet.ConditionalUnet1D(**kw, dtype=jnp.float64)
            want = jax.jit(m.apply)(_to64(variables), sample.astype(np.float64), t, cond.astype(np.float64))
            assert want.dtype == jnp.float64
    else:
        want = jax.jit(junet.ConditionalUnet1D(**kw).apply)(variables, sample, t, cond)
    assert got.shape == want.shape == sample.shape and got.dtype == np.dtype(str(dtype).split(".")[1])
    _close(got, want, dtype, "unet")


BF16_ULP = 2.0 ** -8


def test_groupnorm_in_bf16_takes_float32_statistics_as_flax():
    """`GroupNorm` at dtype bfloat16 on a bf16 input of mean 3 against
    Flax's ``nn.GroupNorm(dtype=bfloat16)``: each element within one bf16
    ulp of Flax's (both take the statistics in float32 and round once;
    statistics taken in bf16 lie thousands of ulps off at this mean)."""
    import flax.linen as fnn

    from diffusiondrive_torch.models.layers import GroupNorm

    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(3.0, 1.0, (2, 16, 64)), jnp.bfloat16)
    params = {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
              "bias": rng.normal(0, 0.02, 64).astype(np.float32)}
    want = fnn.GroupNorm(num_groups=8, epsilon=1e-5, dtype=jnp.bfloat16).apply({"params": params}, x)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    gn = GroupNorm(8, 64, 1e-5, torch.bfloat16)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(params["scale"]))
        gn.bias.copy_(torch.from_numpy(params["bias"]))
        got = gn(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16().transpose(1, 2))
    assert got.dtype == torch.bfloat16
    got = got.transpose(1, 2).float().numpy()
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want))


def within_jax_bf16_accuracy(got, want_bf16, want64, name):
    """The bf16 tier of the UNet pieces: rounding to bf16 all through the
    net leaves JAX's own bf16 output `want_bf16` some distance e from the
    float64 one (more than 2 bf16 ulps of its largest element, so a fixed
    ulp gate cannot hold two bf16 runs), and the port's bf16 output is held
    to that accuracy: within 2e from float64 and within e of JAX's bf16
    output, elementwise maxima."""
    got, want_bf16, want64 = (np.asarray(a, np.float64) for a in (got, want_bf16, want64))
    e = np.abs(want_bf16 - want64).max()
    assert e > 0 and np.abs(got - want64).max() <= 2.0 * e, (name, np.abs(got - want64).max(), e)
    assert np.abs(got - want_bf16).max() <= e, (name, np.abs(got - want_bf16).max(), e)


def test_conditional_unet1d_in_bf16_within_jax_bf16_accuracy():
    """`ConditionalUnet1D` at dtype bfloat16 (float32 parameters, bf16
    compute, float32 GroupNorm statistics) against Flax at dtype bfloat16
    on the same weights, held to JAX's own bf16 accuracy
    (`within_jax_bf16_accuracy`), the output bf16 in both."""
    sample, t, cond = _unet_inputs()
    kw = dict(input_dim=3, global_cond_dim=24, diffusion_step_embed_dim=32, down_dims=DOWN_DIMS)
    variables = seeded_variables(junet.ConditionalUnet1D(**kw), sample, t, cond, seed=1)
    port = load_jax_variables(ConditionalUnet1D(**kw, dtype=torch.bfloat16), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(sample).bfloat16(), torch.from_numpy(t).long(), torch.from_numpy(cond).bfloat16())
    want = jax.jit(junet.ConditionalUnet1D(**kw, dtype=jnp.bfloat16).apply)(
        variables, sample.astype(jnp.bfloat16), t, cond.astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    with jax.enable_x64(True):
        want64 = jax.jit(junet.ConditionalUnet1D(**kw, dtype=jnp.float64).apply)(
            _to64(variables), sample.astype(np.float64), t, cond.astype(np.float64))
    within_jax_bf16_accuracy(got.float().numpy(), want.astype(jnp.float32), want64, "unet bf16")


def _head_cfgs(**kw):
    kw.setdefault("unet_down_dims", (32, 64))
    jcfg = JConfig(**kw)
    return jcfg, _port_config(jcfg)


def test_mlp_head_matches_jax():
    """The Transfuser baseline's head: (x, y) raw, heading tanh x pi."""
    jcfg, pcfg = _head_cfgs()
    ego = np.random.default_rng(6).normal(size=(3, 1, 256)).astype(np.float32)
    variables = seeded_variables(JMLPHead(jcfg), ego, seed=6)
    want = jax.jit(JMLPHead(jcfg).apply)(variables, ego)["trajectory"]
    port = load_jax_variables(MLPTrajectoryHead(pcfg), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(ego))["trajectory"].numpy()
    assert got.shape == (3, 8, 3) and np.abs(got[..., 2]).max() <= np.pi
    _close(got, want, name="mlp head")
    assert port.train_draws(3) == (None, None) and port.draw_noise(3) is None


# --------------------------------------------------------------------------- #
# ResNet-50: the Bottleneck and the features
# --------------------------------------------------------------------------- #

class PortFeatures(torch.nn.Module):
    """The port's stem and stages under the Flax `ResNetFeatures` scopes."""

    def __init__(self, arch: str, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        from diffusiondrive_torch.models.resnet import ARCH_SPECS

        block, sizes, widths, chs = ARCH_SPECS[arch]
        self.stem = ResNetStem(in_channels, dtype)
        cin = 64
        for i in range(4):
            self.add_module(f"layer{i + 1}", ResNetStage(cin, widths[i], sizes[i], 1 if i == 0 else 2, block, dtype))
            cin = chs[i]

    def forward(self, x):
        x, out = self.stem(x), []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            out.append(x)
        return out


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _run_pair(jmodule, port, x, train: bool, dtype=torch.float32):
    """(port outputs NHWC numpy, JAX outputs, JAX's new batch stats or None);
    float64 under `jax.enable_x64` with the Flax module at dtype float64."""
    variables = seeded_variables(jmodule, x, seed=8)
    load_jax_variables(port, variables).to(dtype).train(train)
    with jax.enable_x64(dtype == torch.float64):
        if dtype == torch.float64:
            jmodule, variables, x = jmodule.clone(dtype=jnp.float64), _to64(variables), x.astype(np.float64)
        if train:
            want, mutated = jax.jit(lambda v, a: jmodule.apply(v, a, train=True, mutable=["batch_stats"]))(
                variables, x)
            stats = mutated["batch_stats"]
        else:
            want, stats = jax.jit(lambda v, a: jmodule.apply(v, a, train=False))(variables, x), None
    with torch.no_grad():
        got = port(_nchw(x))
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    return [g.permute(0, 2, 3, 1).numpy() for g in got], [np.asarray(w) for w in want], stats


def _check_stats(port, stats, dtype=torch.float32):
    """Every BN running statistic after a train-mode forward (biased batch
    variance, momentum 0.9) against Flax's."""
    buffers = dict(port.named_buffers())
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + [{"mean": "running_mean", "var": "running_var"}[keys[-1]]])
        _close(buffers[name].numpy(), leaf, dtype, name=name)
        n += 1
    assert n == sum(1 for k in buffers if "running" in k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stride,cin", [(1, 64), (2, 128), (1, 256)])
def test_bottleneck_matches_jax(stride, cin, train):
    """A Bottleneck with a downsample (width or stride) and without one, in
    eval mode and in train mode (batch statistics; the running statistics
    after the forward)."""
    x = np.random.default_rng(9).normal(size=(2, 12, 20, cin)).astype(np.float32)
    port = Bottleneck(cin, 64, stride)
    assert port.has_downsample == (cin != 256 or stride != 1)
    got, want, stats = _run_pair(jresnet.Bottleneck(64, stride), port, x, train)
    assert got[0].shape == want[0].shape == (2, -(-12 // stride), -(-20 // stride), 256)
    _close(got[0], want[0], name="bottleneck")
    if train:
        _check_stats(port, stats)


@pytest.mark.parametrize("train,dtype", [(False, torch.float32), (True, torch.float32), (True, torch.float64)])
def test_resnet50_features_match_jax(train, dtype):
    """The four ResNet-50 stage outputs (256, 512, 1024, 2048 channels) of a
    64x256 camera; eval mode (the stem through its plain version, the
    stages on the module path) and train mode with the BN statistics.

    Train mode in float32 holds 1e-3 x max(1, |JAX|) a stage, the training
    forward's bound of `test_torch_port_train.py`: each of the 53
    batch-statistics BatchNorms divides by a standard deviation taken as
    E[x^2] - E[x]^2 in float32 (Flax's formula) over as few as 32 values a
    channel at layer 4, and summing in another order moves it; the errors
    grow stage by stage (measured 1.4e-4, 4.1e-4, 2.3e-3, 4.6e-3 on values
    up to 9-13). The same forward in float64 shows the arithmetic is the
    same (1e-6, the file's float64 tolerance)."""
    x = np.random.default_rng(10).uniform(size=(2, 64, 256, 3)).astype(np.float32)
    port = PortFeatures("resnet50", 3, dtype)
    got, want, stats = _run_pair(jresnet.ResNetFeatures("resnet50"), port, x, train, dtype)
    assert [g.shape[-1] for g in got] == [256, 512, 1024, 2048]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if train and dtype == torch.float32:
            err, limit = np.abs(g - w).max(), 1e-3 * max(1.0, np.abs(w).max())
            assert err <= limit, (f"layer{i + 1}", err, limit)
        else:
            _close(g, w, dtype, name=f"layer{i + 1}")
    if train and dtype == torch.float64:
        _check_stats(port, stats, dtype)


@pytest.mark.parametrize("fused_mode", ["auto", "train"])
def test_bottleneck_stage_takes_no_conv3x3_kernel(fused_mode):
    """Layer 1 of ResNet-50 at 64 channels, stride 1 (where
    `supports_fused_conv3x3` holds): the Bottleneck stage runs its module
    path on meta tensors in eval and train mode, as JAX's `fused_stage`
    requires a basic block; the basic stage at the same shape reaches the
    conv3x3 wrapper, which raises for a meta tensor (no kernel for it)."""
    x = torch.empty(1, 64, 16, 16, device="meta").contiguous(memory_format=torch.channels_last)
    before = fused_conv3x3.launches
    for train in (False, True):
        stage = ResNetStage(64, 64, 3, 1, "bottleneck", fused_mode=fused_mode).to("meta").train(train)
        with torch.no_grad():
            out = stage(x)
        assert out.device.type == "meta" and out.shape == (1, 256, 16, 16)
    basic = ResNetStage(64, 64, 3, 1, "basic", fused_mode=fused_mode).to("meta").eval()
    with torch.no_grad(), pytest.raises(RuntimeError):
        basic(x)
    assert fused_conv3x3.launches == before
    with pytest.raises(ValueError, match="bottleneck"):
        ResNetStage(64, 64, 1, block="wide")


# --------------------------------------------------------------------------- #
# the converter on the new trees
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tree", ["unet", "mlp", "bottleneck"])
def test_converter_is_strict_on_the_new_trees(tree):
    """Every leaf of each new Flax tree lands on a port tensor of its shape
    and every port tensor is filled; a missing or an extra leaf raises. The
    UNet's 1-D kernels go (k, in, out) -> (out, in, k), its transposed
    convs' -> (in, out, k) with the taps reversed."""
    jcfg, pcfg = _head_cfgs()
    if tree == "unet":
        sample, t, cond = _unet_inputs()
        kw = dict(input_dim=3, global_cond_dim=24, diffusion_step_embed_dim=32, down_dims=DOWN_DIMS)
        variables, port = seeded_variables(junet.ConditionalUnet1D(**kw), sample, t, cond), ConditionalUnet1D(**kw)
        drop = "up0_us"
    elif tree == "mlp":
        ego = np.zeros((1, 1, 256), np.float32)
        variables, port, drop = seeded_variables(JMLPHead(jcfg), ego), MLPTrajectoryHead(pcfg), "fc2"
    else:
        x = np.zeros((1, 8, 8, 64), np.float32)
        variables, port, drop = seeded_variables(jresnet.Bottleneck(32, 2), x), Bottleneck(64, 32, 2), "conv3"
    sd = jax_to_state_dict(variables, port)
    assert set(sd) == set(port.state_dict())
    if tree == "unet":
        k = np.asarray(variables["params"]["up0_us"]["kernel"])      # (k, in, out)
        np.testing.assert_array_equal(sd["up0_us.weight"].numpy(), k.transpose(1, 2, 0)[..., ::-1])
        k = np.asarray(variables["params"]["down0_ds"]["kernel"])
        np.testing.assert_array_equal(sd["down0_ds.weight"].numpy(), k.transpose(2, 1, 0))
        assert "down0_res0.block0.norm.weight" in sd and "down0_res0.residual_conv.weight" in sd
    missing = {c: dict(t) for c, t in variables.items()}
    missing["params"] = {k: v for k, v in variables["params"].items() if k != drop}
    with pytest.raises(KeyError, match="no Flax leaf"):
        jax_to_state_dict(missing, port)
    extra = {c: dict(t) for c, t in variables.items()}
    extra["params"] = dict(variables["params"], bogus={"kernel": np.zeros((3, 2, 2), np.float32)})
    with pytest.raises(KeyError, match="no port tensor"):
        jax_to_state_dict(extra, port)


@pytest.mark.parametrize("head", ["mlp", "unet"])
def test_unused_bev_proj_takes_adamw_decay_as_in_jax(head):
    """Under the MLP and UNet heads `bev_proj` takes no part in the loss:
    JAX's gradient for it is zero, and optax's AdamW still decays it. The
    port's step gives it a zero gradient (torch's AdamW skips a parameter
    whose gradient is None), so after one step it is p (1 - lr wd), the
    update lr 0 / (0 + eps) being 0."""
    from diffusiondrive_torch.entry import build_model
    from diffusiondrive_torch.training.train import OptimizerConfig, create_train_state, train_step

    from test_train import make_batch, tiny_config

    cfg = _port_config(tiny_config())
    model = build_model(cfg, seed=0, trajectory_head_type=head).train()
    before = {k: p.detach().clone() for k, p in model.named_parameters() if k.startswith("bev_proj.")}
    state = create_train_state(model, OptimizerConfig())
    batch = {k: torch.from_numpy(v) for k, v in make_batch(2, seed=1).items()}
    train_step(state, cfg, batch, torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    lr = OptimizerConfig().lr / 3   # WarmupCosLR at step 0, 3 warm-up epochs
    assert before
    for k, p in before.items():
        assert torch.equal(params[k].grad, torch.zeros_like(p)), k
        torch.testing.assert_close(params[k].detach(), p * (1.0 - lr * 1e-4), rtol=1e-7, atol=0, msg=k)


def test_comparison_batch_places_targets_until_the_assignment_is_unique(monkeypatch):
    """`entry.comparison_batch` on the UNet variant at the small width of
    the card's variant test: its first placements leave rows whose optimal
    detection assignment beats another by less than
    `MIN_ASSIGNMENT_MARGIN` (two matches whose L1 centre costs are
    separable tie, and two runs may then take either), so it places those
    rows again; every row of the batch it returns is unique by that margin,
    recomputed here with scipy on the probe's cost
    (`test_torch_port_train.assignment_margin`). With a margin no
    placement reaches, it raises after `PLACEMENT_TRIES` (2 here)."""
    from diffusiondrive_torch import entry
    from diffusiondrive_torch.models.layers import disable_dropout
    from diffusiondrive_torch.training.losses import _ce_cost, _l1_cost

    from test_torch_port_train import assignment_margin

    small = dict(camera_height=64, camera_width=256, lidar_resolution_height=64, lidar_resolution_width=64,
                 img_vert_anchors=2, img_horz_anchors=8, lidar_vert_anchors=2, lidar_horz_anchors=2,
                 bev_pixel_height=32, bev_pixel_width=64, unet_down_dims=(32, 64),
                 image_architecture="resnet18", lidar_architecture="resnet18")
    head, cfg = entry.variant_config("diffusion_policy_agent", **small)
    model = entry.build_model(cfg, seed=0, trajectory_head_type=head).train()
    placements = []
    place = entry.place_targets_at_predictions
    monkeypatch.setattr(entry, "place_targets_at_predictions", lambda *a: placements.append(1) or place(*a))
    batch, ts, noise = entry.comparison_batch(model, cfg, 2, seed=0)
    assert len(placements) > 1
    probe = copy.deepcopy(model).train()
    disable_dropout(probe)
    with torch.no_grad():
        out = probe(*(torch.from_numpy(batch[k]) for k in ("camera_feature", "lidar_feature", "status_feature")),
                    targets={"trajectory": torch.from_numpy(batch["trajectory"])}, timesteps=ts,
                    diffusion_noise=noise)
    valid = torch.from_numpy(batch["agent_labels"]).float()
    cost = (cfg.agent_class_weight * _ce_cost(valid, out["agent_labels"])
            + cfg.agent_box_weight * _l1_cost(torch.from_numpy(batch["agent_states"]), out["agent_states"], valid))
    for c, v in zip(cost.double().numpy(), valid.bool().numpy()):
        assert assignment_margin(c, v) >= entry.MIN_ASSIGNMENT_MARGIN - 1e-5
    monkeypatch.setattr(entry, "MIN_ASSIGNMENT_MARGIN", 1e6)
    monkeypatch.setattr(entry, "PLACEMENT_TRIES", 2)
    with pytest.raises(RuntimeError, match="no placement with a unique detection assignment"):
        entry.comparison_batch(model, cfg, 2, seed=0)
