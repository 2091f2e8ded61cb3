"""Parity of the 20-step vanilla-DDIM agent's forward with the JAX package, on the CPU.

The registry's `diffusiondrive_vanilla_ddim_agent` is the default
DiffusionDrive model with `diffusion_test_steps=20`: its eval forward runs
20 DDIM cascades where the default agent runs 2. At a small size
(`tests/test_train.py:tiny_config` with one GPT, one transformer-decoder and
one diffusion-decoder layer; XLA compiles the 20 unrolled cascades in ~13 s), the
same seeded weights (`seeded_variables`, ported by `utils/port_jax.py`),
inputs and fixed noise go through one jitted JAX forward and the port's,
in float32, the port on the module path (`fused_conv_mode="off"`, JAX's path
off the TPU) and on the default path (the kernels' plain versions on the
CPU). Gate: every output within 1e-4 x max(1, |JAX|) and the same argmax
mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.models.diffusion_head import default_plan_anchors as j_default_plan_anchors
from diffusiondrive_tpu.models.transfuser_model import DiffusionDriveModel as JModel

from diffusiondrive_torch.entry import VARIANTS, variant_config
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel
from diffusiondrive_torch.utils.port_jax import load_jax_variables

from test_torch_port_model import _port_config
from test_torch_port_variants import seeded_variables
from test_train import make_batch, tiny_config

NAME = "diffusiondrive_vanilla_ddim_agent"
B = 2
TOL = 1e-4
SMALL = dict(n_layer=1, tf_num_layers=1, diff_decoder_layers=1)
INPUTS = ("camera_feature", "lidar_feature", "status_feature")


@pytest.fixture(scope="module")
def forwards():
    """(JAX outputs, port outputs by path, port config) of one forward."""
    assert NAME in VARIANTS
    jcfg = dataclasses.replace(tiny_config(), **SMALL, diffusion_test_steps=20)
    head, pcfg = variant_config(NAME, **{k: getattr(jcfg, k) for k in (
        "image_architecture", "lidar_architecture", "camera_height", "camera_width", "lidar_resolution_height",
        "lidar_resolution_width", "img_vert_anchors", "img_horz_anchors", "lidar_vert_anchors",
        "lidar_horz_anchors", "bev_pixel_height", "bev_pixel_width", *SMALL)})
    assert head == "diffusion" and pcfg == _port_config(jcfg) and pcfg.diffusion_test_steps == 20
    batch = make_batch(B, seed=9)
    inputs = [batch[k] for k in INPUTS]
    noise = np.random.default_rng(4).normal(size=(B, jcfg.ego_fut_mode, jcfg.num_poses, 2)).astype(np.float32)
    jmodel = JModel(jcfg)
    # the variables of the 20-step model are those of a 1-step one, whose abstract trace is shorter
    variables = seeded_variables(JModel(dataclasses.replace(jcfg, diffusion_test_steps=1)), *inputs, seed=6,
                                 constants={"plan_anchor": j_default_plan_anchors(jcfg.ego_fut_mode, jcfg.num_poses)})
    want = jax.jit(lambda v, c, l, s, n: jmodel.apply(v, c, l, s, diffusion_noise=n))(
        variables, *map(jnp.asarray, inputs), jnp.asarray(noise))
    got = {}
    for mode in ("off", "auto"):
        model = load_jax_variables(DiffusionDriveModel(dataclasses.replace(pcfg, fused_conv_mode=mode)),
                                   variables).eval()
        with torch.no_grad():
            got[mode] = model(*map(torch.from_numpy, inputs), diffusion_noise=torch.from_numpy(noise))
    return jax.tree_util.tree_map(np.asarray, want), got, pcfg


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_vanilla_ddim_forward_matches_jax(forwards, mode):
    want, got, pcfg = forwards
    out = got[mode]
    assert set(out) == set(want)
    assert out["trajectory"].shape == (B, pcfg.num_poses, 3)
    for k, w in want.items():
        g = out[k].numpy()
        assert g.shape == w.shape, k
        err = np.abs(g - w).max()
        assert err <= TOL * max(1.0, np.abs(w).max()), (k, err)
    np.testing.assert_array_equal(out["poses_cls"].argmax(-1).numpy(), want["poses_cls"].argmax(-1))
