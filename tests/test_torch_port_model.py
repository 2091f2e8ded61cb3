"""Port parity of the planner forward, the weight converter and the package rules.

The JAX `DiffusionDriveModel(tiny_config())` with randomized BN statistics
and fixed diffusion noise is carried into the port through
`utils/port_jax.py`; both run the same numpy inputs, the port on the CPU in
float32. Tolerances as in `tests/test_torch_parity.py`.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.models.transfuser_model import DiffusionDriveModel as JModel

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.layers import TransformerDecoder
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel
from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
from diffusiondrive_torch.ops.stem_fused import fused_stem
from diffusiondrive_torch.utils.port_jax import jax_to_state_dict, load_jax_variables

from test_train import CAM_H, CAM_W, LID, tiny_config

REPO = Path(__file__).resolve().parent.parent


def _port_config(jcfg):
    """The port's config with the same field values as the JAX one."""
    fields = TransfuserConfig.__dataclass_fields__
    return TransfuserConfig(**{k: getattr(jcfg, k) for k in fields if k != "trajectory_sampling"})


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = tiny_config()
    jmodel = JModel(jcfg)
    rng = np.random.default_rng(7)
    inputs = (rng.uniform(size=(2, CAM_H, CAM_W, 3)).astype(np.float32),
              rng.uniform(size=(2, LID, LID, 1)).astype(np.float32),
              rng.normal(size=(2, 8)).astype(np.float32))
    noise = rng.normal(size=(2, jcfg.ego_fut_mode, jcfg.num_poses, 2)).astype(np.float32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0),
                                      "diffusion": jax.random.PRNGKey(1)}, *inputs)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.3, a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.7, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return jcfg, jmodel, variables, inputs, noise


def test_tiny_planner_forward_matches_jax(tiny_pair):
    jcfg, jmodel, variables, inputs, noise = tiny_pair
    want = jax.jit(lambda v, c, l, s, n: jmodel.apply(v, c, l, s, diffusion_noise=n))(
        variables, *[jnp.asarray(a) for a in inputs], jnp.asarray(noise))
    model = load_jax_variables(DiffusionDriveModel(_port_config(jcfg)), variables).eval()
    with torch.no_grad():
        got = model(*[torch.from_numpy(a) for a in inputs], diffusion_noise=torch.from_numpy(noise))

    for name, atol in [("bev_semantic_map", 2e-4), ("agent_states", 2e-4), ("agent_labels", 2e-4),
                       ("poses_cls", 5e-4), ("poses_reg", 1e-3), ("trajectory", 1e-3)]:
        assert got[name].shape == tuple(want[name].shape), name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=atol, rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(got["poses_cls"].argmax(-1).numpy(),
                                  np.asarray(want["poses_cls"]).argmax(-1))


def test_uint8_camera_is_normalized_in_the_forward(tiny_pair):
    jcfg, _, variables, inputs, noise = tiny_pair
    model = load_jax_variables(DiffusionDriveModel(_port_config(jcfg)), variables).eval()
    cam8 = (np.asarray(inputs[0]) * 255).astype(np.uint8)
    rest = [torch.from_numpy(a) for a in inputs[1:]]
    with torch.no_grad():
        a = model(torch.from_numpy(cam8), *rest, diffusion_noise=torch.from_numpy(noise))
        b = model(torch.from_numpy(cam8.astype(np.float32) / 255.0), *rest,
                  diffusion_noise=torch.from_numpy(noise))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_converter_is_strict(tiny_pair):
    jcfg, _, variables, _, _ = tiny_pair
    model = DiffusionDriveModel(_port_config(jcfg))
    sd = jax_to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    # a missing Flax leaf leaves a port tensor unfilled
    missing = {c: dict(t) for c, t in variables.items()}
    missing["params"] = {k: v for k, v in variables["params"].items() if k != "status_encoding"}
    with pytest.raises(KeyError, match="no Flax leaf"):
        jax_to_state_dict(missing, model)
    # an extra Flax leaf has nowhere to go
    extra = {c: dict(t) for c, t in variables.items()}
    extra["params"] = dict(variables["params"], bogus={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="no port tensor"):
        jax_to_state_dict(extra, model)
    # a shape that disagrees
    dec = TransformerDecoder(8, 2, 16, 1)
    bad = {"params": {"layer0": {"linear1": {"kernel": np.zeros((8, 15), np.float32)}}}}
    with pytest.raises(ValueError, match="shape"):
        jax_to_state_dict(bad, dec)


def test_entry_raises_without_gpu_unless_cpu_is_asked():
    from diffusiondrive_torch.device import resolve_device
    from diffusiondrive_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    assert resolve_device("cpu") == torch.device("cpu")


def test_seeded_model_and_inputs_give_a_finite_forward():
    """`entry.build_model` / `example_inputs` (what `chip_smoke.py` drives at
    full width on the card), at the tiny config on the CPU."""
    from diffusiondrive_torch.entry import build_model, example_inputs

    cfg = _port_config(tiny_config())
    model = build_model(cfg, seed=3)
    assert not model.training
    bn = model.backbone.image_encoder_stem.bn1
    assert bn.running_var.min() >= 0.7 and bn.running_mean.abs().max() > 0
    inputs = example_inputs(cfg, 2, torch.device("cpu"), seed=4)
    assert inputs["camera_feature"].dtype == torch.uint8
    with torch.no_grad():
        out = model(**inputs, generator=torch.Generator().manual_seed(0))
        again = build_model(cfg, seed=3)(**inputs, generator=torch.Generator().manual_seed(0))
    assert out["trajectory"].shape == (2, cfg.num_poses, 3)
    assert out["bev_semantic_map"].shape == (2, *cfg.bev_semantic_frame, cfg.num_bev_classes)
    for k in out:
        assert torch.isfinite(out[k]).all(), k
        torch.testing.assert_close(out[k], again[k], rtol=0, atol=0)


_GUARD = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import diffusiondrive_torch
from diffusiondrive_torch.ops import _build
before = sorted(_build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else []
for m in pkgutil.walk_packages(diffusiondrive_torch.__path__, "diffusiondrive_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "diffusiondrive_tpu"))
assert not bad, bad
after = sorted(_build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else []
assert before == after and not _build._libs, "importing built a kernel"
print("ok", len([m for m in sys.modules if m.startswith("diffusiondrive_torch.")]))
"""


def test_port_imports_no_jax_and_builds_nothing_on_import():
    """In a fresh interpreter (this process has JAX loaded by conftest)."""
    proc = subprocess.run([sys.executable, "-c", _GUARD, str(REPO)], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_and_prints_no_result_without_a_gpu(where, tmp_path):
    """Run from the repo root or from a directory that holds only the script:
    without a CUDA device it exits non-zero before printing anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=120, cwd=script.parent)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_eval_path_goes_through_the_fused_ops_and_cpu_launches_nothing(tiny_pair, monkeypatch):
    """Both stems and every layer-1 conv (resnet18: 2 blocks x 2 convs x 2
    branches) reach the fused wrappers, which take their plain versions on
    the CPU and count no kernel launch."""
    from diffusiondrive_torch.ops import conv_fused, stem_fused

    calls = {"stem": 0, "conv": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(stem_fused, "stem_plain", counting("stem", stem_fused.stem_plain))
    monkeypatch.setattr(conv_fused, "conv3x3_plain", counting("conv", conv_fused.conv3x3_plain))
    jcfg, _, variables, inputs, noise = tiny_pair
    model = load_jax_variables(DiffusionDriveModel(_port_config(jcfg)), variables).eval()
    stem0, conv0 = fused_stem.launches, fused_conv3x3.launches
    with torch.no_grad():
        model(*[torch.from_numpy(a) for a in inputs], diffusion_noise=torch.from_numpy(noise))
    assert calls == {"stem": 2, "conv": 8}
    assert (fused_stem.launches, fused_conv3x3.launches) == (stem0, conv0)
