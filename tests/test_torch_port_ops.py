"""Port parity of the plain ops and layers: `diffusiondrive_torch` vs `diffusiondrive_tpu`.

Inputs come from a numpy seed and go to both packages; the port runs on the
CPU in float32. Tolerances are float32 round-off of the op at these sizes
unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.models import layers as jl
from diffusiondrive_tpu.ops import ddim as jddim
from diffusiondrive_tpu.ops import embed as jembed
from diffusiondrive_tpu.ops import sampling as jsampling

from diffusiondrive_torch.models import layers as tl
from diffusiondrive_torch.ops import ddim as tddim
from diffusiondrive_torch.ops import embed as tembed
from diffusiondrive_torch.ops import sampling as tsampling
from diffusiondrive_torch.utils.port_jax import load_jax_variables


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, atol, rtol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_ddim_tables_add_noise_and_step():
    rng = np.random.default_rng(0)
    js, ts = jddim.DDIMScheduler(), tddim.DDIMScheduler()
    np.testing.assert_array_equal(ts.alphas_cumprod, js.alphas_cumprod)
    assert ts.truncated_rollout_timesteps(2, 20) == js.truncated_rollout_timesteps(2, 20) == (10, 0)
    x0 = rng.normal(size=(3, 20, 8, 2)).astype(np.float32)
    eps = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 8, 999], np.int32)
    _close(ts.add_noise(_t(x0), _t(eps), _t(t).long()), js.add_noise(x0, eps, t), 1e-6)
    for k in (10, 0):
        _close(ts.step(_t(x0) * 1.5, k, _t(eps)), js.step(x0 * 1.5, k, eps), 1e-5)


def test_embeddings():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-30, 60, size=(2, 5, 8, 2)).astype(np.float32)
    _close(tembed.gen_sineembed_for_position(_t(pos), 64),
           jembed.gen_sineembed_for_position(pos, 64), 2e-5)
    t = np.array([0, 8, 10, 999], np.int32)
    _close(tembed.sinusoidal_pos_emb(_t(t), 256), jembed.sinusoidal_pos_emb(t, 256), 2e-5)


def test_grid_sample_including_out_of_bounds():
    rng = np.random.default_rng(2)
    value = rng.normal(size=(2, 6, 9, 5)).astype(np.float32)           # NHWC
    # half the points land outside [-1, 1] (zero padding, partial corners)
    grid = rng.uniform(-1.6, 1.6, size=(2, 4, 7, 2)).astype(np.float32)
    got = tsampling.grid_sample_2d(_t(value).permute(0, 3, 1, 2), _t(grid))
    _close(got, jsampling.grid_sample_2d(value, grid), 1e-5)


@pytest.mark.parametrize("src,dst", [((2, 8), (64, 256)), ((8, 8), (16, 16)), ((4, 4), (4, 4))])
def test_resize_bilinear_upsample(src, dst):
    x = np.random.default_rng(3).normal(size=(2, *src, 3)).astype(np.float32)
    got = tsampling.resize_bilinear(_t(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1)
    _close(got, jsampling.resize_bilinear(x, dst), 1e-5)
    with pytest.raises(ValueError):
        tsampling.resize_bilinear(_t(x).permute(0, 3, 1, 2), (src[0] - 1, src[1]))


def test_adaptive_pool_and_take_rows():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 64, 3)).astype(np.float32)
    got = tsampling.adaptive_avg_pool2d(_t(x).permute(0, 3, 1, 2), (2, 8)).permute(0, 2, 3, 1)
    _close(got, jsampling.adaptive_avg_pool2d(x, (2, 8)), 1e-6)
    arr = rng.normal(size=(3, 20, 8, 3)).astype(np.float32)
    idx = np.array([[4], [19], [0]], np.int32)
    _close(tsampling.take_rows(_t(arr), _t(idx).long()), jsampling.onehot_take_rows(arr, idx), 1e-6)


def test_profile_busy_time_is_the_union_of_kernel_intervals():
    from diffusiondrive_torch.script.run_profile import _busy_us

    assert _busy_us([]) == 0.0
    assert _busy_us([(10.0, 12.0), (0.0, 5.0), (3.0, 8.0), (8.0, 9.0)]) == 11.0


def _flax_and_port(flax_module, port_module, *inputs):
    """Init the Flax module from a seed, carry its params into the port
    module, run both on the same numpy inputs."""
    variables = jax.jit(flax_module.init)(jax.random.PRNGKey(0), *inputs)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    load_jax_variables(port_module, variables)
    want = flax_module.apply(variables, *inputs)
    with torch.no_grad():
        got = port_module.eval()(*[_t(a) for a in inputs])
    return got, want


def test_transformer_decoder():
    rng = np.random.default_rng(5)
    tgt = rng.normal(size=(2, 7, 32)).astype(np.float32)
    mem = rng.normal(size=(2, 5, 32)).astype(np.float32)
    got, want = _flax_and_port(jl.TransformerDecoder(32, 4, 64, 2),
                               tl.TransformerDecoder(32, 4, 64, 2), tgt, mem)
    _close(got, want, 2e-5)


def test_multihead_attention_linear_relu_ln_mish():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 6, 16)).astype(np.float32)
    kv = rng.normal(size=(2, 3, 16)).astype(np.float32)
    got, want = _flax_and_port(jl.MultiHeadAttention(16, 2), tl.MultiHeadAttention(16, 2), q, kv, kv)
    _close(got, want, 2e-5)
    x = rng.normal(size=(2, 4, 24)).astype(np.float32)
    got, want = _flax_and_port(jl.LinearReluLn(16, 1, 2), tl.LinearReluLn(24, 16, 1, 2), x)
    _close(got, want, 2e-5)
    # eps 1e-6 (Flax), not torch's 1e-5: visible where the variance is ~1e-6
    flat = 1e-3 * rng.normal(size=(1, 1, 16)).astype(np.float32)
    got, want = _flax_and_port(jl.LinearReluLn(16, 0, 1), tl.LinearReluLn(16, 16, 0, 1), flat)
    _close(got, want, 1e-4, rtol=1e-4)
    z = rng.normal(scale=5.0, size=(64,)).astype(np.float32)
    _close(tl.mish(_t(z)), jl.mish(jnp.asarray(z)), 1e-5)
