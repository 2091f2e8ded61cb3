"""Port parity of the kernel modules: fused stem and layer-1 conv.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels run in interpret mode, at the shapes of
`tests/test_stem_fused.py` and `tests/test_conv_fused.py`, in float32 at
1e-4 (sums taken in another order). The CUDA kernels themselves are held
against these plain versions on the card by `tests/test_torch_port_cuda.py`.
"""

import jax
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.models.resnet import ResNetStage as JResNetStage
from diffusiondrive_tpu.models.resnet import ResNetStem as JResNetStem
from diffusiondrive_tpu.ops.conv_fused import fused_conv3x3 as j_fused_conv3x3
from diffusiondrive_tpu.ops.stem_fused import fused_stem as j_fused_stem

from diffusiondrive_torch.models.resnet import ResNetStage, ResNetStem
from diffusiondrive_torch.models.resnet import BasicBlock
from diffusiondrive_torch.ops.conv_fused import bn_eval_affine, conv3x3_plain, fused_conv3x3, to_hwio
from diffusiondrive_torch.ops.stem_fused import fused_stem, stem_plain, supports_fused_stem
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
    """In eval mode the stem and the layer-1 block call the wrapper for any
    input: off the CPU it launches the kernel or raises, with no plain path."""
    module = module.to("meta").eval()
    with torch.no_grad(), pytest.raises(error):
        module(x.to("meta"))


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
