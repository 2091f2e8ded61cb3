"""Port parity of the kernel modules: fused stem and layer-1 conv.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels run in interpret mode, at the shapes of
`tests/test_stem_fused.py` and `tests/test_conv_fused.py`, in float32 at
1e-4 (sums taken in another order), and both plain versions also in bf16,
within one bf16 ulp (both round once, at the end). The CUDA kernels
themselves are held against these plain versions on the card by
`tests/test_torch_port_cuda.py`; the bf16 stem kernel's space-to-depth form
is held to the 7x7/s2 conv here (`stem_conv_s2d`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.models.resnet import ResNetStage as JResNetStage
from diffusiondrive_tpu.models.resnet import ResNetStem as JResNetStem
from diffusiondrive_tpu.ops.conv_fused import fused_conv3x3 as j_fused_conv3x3
from diffusiondrive_tpu.ops.stem_fused import fused_stem as j_fused_stem

from diffusiondrive_torch.models.resnet import ResNetStage, ResNetStem
from diffusiondrive_torch.models.resnet import BasicBlock, _kernel_operands
from diffusiondrive_torch.ops.conv_fused import (
    bn_eval_affine, conv3x3_plain, fused_conv3x3, supports_fused_conv3x3, to_hwio)
from diffusiondrive_torch.ops.stem_fused import (
    fused_stem, stem_conv_s2d, stem_kernel, stem_plain, supports_fused_stem)
from diffusiondrive_torch.utils.port_jax import load_jax_variables


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _stem_inputs(seed, B, H, W, C, bias=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = rng.normal(size=(7, 7, C, 64)).astype(np.float32) * 0.1          # HWIO
    sc = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bi = (rng.normal(size=64) * 0.1).astype(np.float32) if bias is None else np.full(64, bias, np.float32)
    return x, w, sc, bi


@pytest.mark.parametrize("B,H,W,C,bias", [(2, 64, 512, 3, None), (1, 64, 1024, 1, None),
                                          (1, 64, 512, 3, -2.0)])
def test_stem_matches_jax_pallas_interpret(B, H, W, C, bias):
    """bias -2 drives whole regions to ReLU zero: the pool's zero padding
    must still equal -inf padding at every edge."""
    x, w, sc, bi = _stem_inputs(0, B, H, W, C, bias)
    want = np.asarray(j_fused_stem(x, w, sc, bi, interpret=True))
    got = fused_stem(_nchw(x), torch.from_numpy(w), torch.from_numpy(sc), torch.from_numpy(bi))
    assert got.shape == (B, 64, H // 4, W // 4)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def _within_one_bf16_ulp_of(got, want):
    """One bf16 ulp of max |want|, and elementwise one ulp of each |want|
    value (above 2^-16 max |want|, where f32 sums in another order may tip a
    rounding)."""
    err, top = np.abs(got - want), np.abs(want).max()
    assert err.max() <= 2.0 ** (np.floor(np.log2(top)) - 7)
    ulps = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -16 * top))) - 7)
    assert (err <= ulps).all(), int((err > ulps).sum())


@pytest.mark.parametrize("C", [1, 3])
def test_stem_plain_rounds_once_in_bf16_as_jax(C):
    """bf16 inputs at (1, 64, 512, C), the smallest shape JAX's gate takes:
    JAX's kernel sums in f32, applies the affine and the ReLU in f32 and
    rounds to bf16 once (the max-pool commutes with the rounding); the
    port's plain version (what the card's kernel is held to) must round at
    the same place, within the limits of
    `test_conv3x3_plain_rounds_once_in_bf16_as_jax`. The old plain version,
    which rounded the conv to bf16 before the affine and again after the
    ReLU, broke the elementwise limit at 1447 (C=3) and 3706 (C=1) of the
    131072 outputs."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 64, 512, C)).astype(np.float32)
    w = (rng.normal(size=(7, 7, C, 64)) * 0.1).astype(np.float32)
    sc = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bi = rng.normal(size=64).astype(np.float32)
    bf = jnp.bfloat16
    want = np.asarray(j_fused_stem(jnp.asarray(x, bf), jnp.asarray(w, bf), sc, bi,
                                   interpret=True).astype(jnp.float32))
    t = torch.bfloat16
    got = fused_stem(_nchw(x).to(t), torch.from_numpy(w).to(t), torch.from_numpy(sc),
                     torch.from_numpy(bi))
    assert got.dtype == t and stem_kernel(t) == "mma" and stem_kernel(torch.float32) == "mma_tf32x3"
    _within_one_bf16_ulp_of(_nhwc(got.float()), want)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_stem_space_to_depth_form_equals_the_strided_conv(C):
    """The bf16 kernel's form of the conv (2x2 space-to-depth, channels
    padded to 16, a 4x4/s1 conv whose output y reads s2d rows y-2 .. y+1,
    tap (dr, dc) <- 7x7 tap (2dr+pr-1, 2dc+pc-1)) equals the 7x7/s2/pad3
    conv in float32, at edges that are not multiples of the kernel's tiles
    (H=36, W=100: 18x50 conv outputs, 9x25 pooled)."""
    g = torch.Generator().manual_seed(C)
    x = torch.randn(2, C, 36, 100, generator=g)
    w = torch.randn(7, 7, C, 64, generator=g) * 0.1
    want = torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), stride=2, padding=3)
    torch.testing.assert_close(stem_conv_s2d(x, w), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("residual,relu", [(False, False), (False, True), (True, True)])
def test_conv3x3_matches_jax_pallas_interpret(residual, relu):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(1, 16, 32, 64)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(3, 3, 64, 64)) * 0.2).astype(np.float32)
    sc = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bi = rng.normal(size=64).astype(np.float32)
    res = rng.normal(size=x.shape).astype(np.float32) if residual else None
    want = np.asarray(j_fused_conv3x3(x, w, sc, bi, residual=res, relu=relu, interpret=True))
    got = fused_conv3x3(_nchw(x), torch.from_numpy(w), torch.from_numpy(sc),
                        torch.from_numpy(bi), None if res is None else _nchw(res), relu=relu)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("residual,relu", [(False, False), (True, True)])
def test_conv3x3_plain_rounds_once_in_bf16_as_jax(residual, relu):
    """bf16 inputs: JAX's kernel sums in f32, applies the affine, the residual
    and the ReLU in f32 and rounds to bf16 once; the port's plain version
    (what the card's kernel is held to) must round at the same place, so the
    two differ by at most one rounding: one bf16 ulp of max |JAX|, and
    elementwise one ulp of each |JAX| value (above 2^-16 max |JAX|, where
    f32 sums in another order may tip a rounding). Rounding the conv to
    bf16 before the affine breaks the elementwise limit thousands of times."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(1, 16, 32, 64)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(3, 3, 64, 64)) * 0.05).astype(np.float32)
    sc = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bi = rng.normal(size=64).astype(np.float32)
    res = rng.normal(size=x.shape).astype(np.float32) if residual else None
    bf = jnp.bfloat16
    want = np.asarray(j_fused_conv3x3(jnp.asarray(x, bf), jnp.asarray(w, bf), sc, bi,
                                      residual=None if res is None else jnp.asarray(res, bf),
                                      relu=relu, interpret=True).astype(jnp.float32))
    t = torch.bfloat16
    got = fused_conv3x3(_nchw(x).to(t), torch.from_numpy(w).to(t), torch.from_numpy(sc),
                        torch.from_numpy(bi), None if res is None else _nchw(res).to(t), relu=relu)
    assert got.dtype == t
    _within_one_bf16_ulp_of(_nhwc(got.float()), want)


def _randomize_bn(variables, seed):
    """Randomized BN statistics (mean ~ N(0, 0.3), var ~ U(0.7, 1.5)) so that
    a wrong fold or a swapped mean/var shows."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.3, a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.7, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return {"params": params, "batch_stats": stats}


def test_resnet_stem_module_matches_jax_interpret():
    x = np.random.default_rng(2).normal(size=(2, 64, 512, 3)).astype(np.float32)
    jstem = JResNetStem(fused_mode="interpret")
    variables = _randomize_bn(jax.jit(jstem.init)(jax.random.PRNGKey(0), x), 3)
    want = np.asarray(jstem.apply(variables, x))
    stem = load_jax_variables(ResNetStem(3), variables).eval()
    with torch.no_grad():
        got = stem(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_layer1_stage_module_matches_jax_interpret():
    x = (np.random.default_rng(4).normal(size=(2, 8, 16, 64)) * 0.5).astype(np.float32)
    jstage = JResNetStage(64, 3, stride=1, fused_mode="interpret")
    variables = _randomize_bn(jax.jit(jstage.init)(jax.random.PRNGKey(0), x), 5)
    want = np.asarray(jstage.apply(variables, x))
    stage = load_jax_variables(ResNetStage(64, 64, 3), variables).eval()
    with torch.no_grad():
        got = stage(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    stem0, conv0 = fused_stem.launches, fused_conv3x3.launches
    x = torch.randn(1, 3, 16, 32)
    w = torch.randn(7, 7, 3, 64) * 0.1
    s, b = torch.rand(64) + 0.5, torch.randn(64)
    torch.testing.assert_close(fused_stem(x, w, s, b), stem_plain(x, w, s, b), rtol=0, atol=0)
    y = torch.randn(1, 64, 8, 8)
    w3 = torch.randn(3, 3, 64, 64) * 0.1
    torch.testing.assert_close(fused_conv3x3(y, w3, s, b, residual=y, relu=True),
                               conv3x3_plain(y, w3, s, b, residual=y, relu=True), rtol=0, atol=0)
    assert (fused_stem.launches, fused_conv3x3.launches) == (stem0, conv0)


def test_gates_and_bn_fold():
    assert supports_fused_stem(torch.zeros(1, 3, 256, 1024))
    assert supports_fused_stem(torch.zeros(1, 1, 256, 256))
    assert not supports_fused_stem(torch.zeros(1, 5, 64, 64))      # C > 4
    assert not supports_fused_stem(torch.zeros(1, 3, 66, 64))      # H % 4
    # off the CPU there is no plain version: an operand the kernel does not
    # take raises (a meta tensor stands in for a CUDA one here)
    meta = torch.device("meta")
    s64, b64 = torch.ones(64, device=meta), torch.zeros(64, device=meta)
    with pytest.raises(ValueError, match="shape"):
        fused_stem(torch.empty(1, 5, 64, 64, device=meta), torch.empty(7, 7, 5, 64, device=meta), s64, b64)
    with pytest.raises(ValueError, match="HWIO"):
        fused_stem(torch.empty(1, 3, 64, 64, device=meta).contiguous(memory_format=torch.channels_last),
                   torch.empty(64, 3, 7, 7, device=meta), s64, b64)
    with pytest.raises(ValueError, match="shape"):
        fused_conv3x3(torch.empty(1, 32, 8, 8, device=meta), torch.empty(3, 3, 32, 64, device=meta),
                      s64, b64)
    with pytest.raises(ValueError, match="float32"):
        fused_conv3x3(torch.empty(1, 64, 8, 8, device=meta).contiguous(memory_format=torch.channels_last),
                      torch.empty(3, 3, 64, 64, device=meta), s64.half(), b64)
    # |bias| >> |scale|: the f32 fold stays exact where a bf16 fold cancels
    one = torch.ones(8)
    s, b = bn_eval_affine(one, 4.0 * one, 40.0 * one, 1e4 * one)
    want_s = 1.0 / np.sqrt(1e4 + 1e-5)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), 4.0 - 40.0 * want_s, rtol=1e-6)
    assert s.dtype == b.dtype == torch.float32


@pytest.mark.parametrize("module,x,error", [
    (ResNetStem(3), torch.empty(1, 3, 64, 64), RuntimeError),      # taken: no kernel for meta
    (ResNetStem(5), torch.empty(1, 5, 64, 64), ValueError),        # C > 4
    (ResNetStem(3), torch.empty(1, 3, 66, 64), ValueError),        # H % 4
    (BasicBlock(64, 64), torch.empty(1, 64, 8, 8), RuntimeError),  # taken: no kernel for meta
])
def test_eval_modules_reach_the_wrapper_off_the_cpu(module, x, error):
    """In eval mode the layer-1 block, and the stem for every input that
    `supports_fused_stem` takes, call the wrapper: off the CPU it launches
    the kernel or raises (`error`), with no plain path. A stem input the
    kernel does not take goes the module path, as JAX's stem does, and the
    wrapper itself still raises `error` for it."""
    module = module.to("meta").eval()
    x = x.to("meta")
    if isinstance(module, BasicBlock) or supports_fused_stem(x):
        with torch.no_grad(), pytest.raises(error):
            module(x)
        return
    with torch.no_grad():
        out = module(x)
    assert out.device.type == "meta" and out.shape == (1, 64, -(-x.shape[2] // 4), -(-x.shape[3] // 4))
    w, s, b = _kernel_operands(module, "conv1", "bn1", torch.float32)
    with pytest.raises(error, match="shape"):
        fused_stem(x.contiguous(memory_format=torch.channels_last), w, s, b)


def test_resnet_stem_takes_the_module_path_where_jax_does():
    """C=6 (a ground-plane lidar of 3 sweeps, `TransfuserConfig(
    use_ground_plane=True, lidar_seq_len=3)`): `supports_fused_stem` fails,
    so both packages' eval stems run conv, BN, ReLU and max-pool; equal
    within 1e-4."""
    x = np.random.default_rng(6).normal(size=(2, 32, 64, 6)).astype(np.float32)
    assert not supports_fused_stem(_nchw(x))
    jstem = JResNetStem(fused_mode="interpret")
    variables = _randomize_bn(jax.jit(jstem.init)(jax.random.PRNGKey(1), x), 7)
    want = np.asarray(jstem.apply(variables, x))
    stem = load_jax_variables(ResNetStem(6), variables).eval()
    with torch.no_grad():
        got = stem(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_basic_block_takes_the_module_path_where_jax_does():
    """W = 15 (odd): JAX's `supports_fused_conv3x3` fails, so both packages'
    layer-1 blocks run conv, BN, ReLU and the residual (equal within 1e-4).
    Off the CPU (a meta tensor stands in for a CUDA one, where a kernel
    call raises) the port's block reaches no conv3x3 wrapper in eval nor in
    train with `fused_mode="train"`; at W = 16 it does, in both."""
    x = (np.random.default_rng(8).normal(size=(2, 8, 15, 64)) * 0.5).astype(np.float32)
    assert not supports_fused_conv3x3(_nchw(x), 64, 1)
    assert supports_fused_conv3x3(torch.zeros(2, 64, 8, 16), 64, 1)
    jstage = JResNetStage(64, 1, stride=1, fused_mode="interpret")
    variables = _randomize_bn(jax.jit(jstage.init)(jax.random.PRNGKey(2), x), 9)
    want = np.asarray(jstage.apply(variables, x))
    stage = load_jax_variables(ResNetStage(64, 64, 1), variables).eval()
    with torch.no_grad():
        got = stage(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)

    launches = fused_conv3x3.launches
    for train in (False, True):
        block = BasicBlock(64, 64, fused_mode="train").to("meta").train(train)
        with torch.no_grad():
            assert block(torch.empty(2, 64, 8, 15, device="meta")).shape == (2, 64, 8, 15)
            with pytest.raises(RuntimeError, match="no kernel"):
                block(torch.empty(2, 64, 8, 16, device="meta"))
    assert fused_conv3x3.launches == launches


def test_kernel_operands_follow_parameter_updates():
    """The cached HWIO weight and BN affine are made again after an in-place
    update and after a load_state_dict."""
    torch.manual_seed(0)
    stem = ResNetStem(3).eval()
    x = torch.randn(1, 3, 16, 32)

    def want():
        return stem_plain(x, to_hwio(stem.conv1.weight, torch.float32), *stem.bn1.eval_affine())

    with torch.no_grad():
        torch.testing.assert_close(stem(x), want(), rtol=0, atol=0)
        stem.bn1.running_mean.add_(0.5)
        stem.conv1.weight.mul_(-1.0)
        torch.testing.assert_close(stem(x), want(), rtol=0, atol=0)
        state = {k: v * 2 for k, v in stem.state_dict().items()}
        stem.load_state_dict(state)
        torch.testing.assert_close(stem(x), want(), rtol=0, atol=0)
