"""Port parity of the diffusion-policy head (`UnetTrajectoryHead`) against
the JAX package, on the CPU: the 20-step DDIM rollout from given noise in
float32 and in float64, and the training forward with given draws.

Helpers and tolerances are those of `test_torch_port_variants.py`. JAX
runs the head op by op: jitting its 20 unrolled UNet calls costs ~25 s a
dtype, op by op ~11 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.models.diffusion_head import UnetTrajectoryHead as JUnetHead

from diffusiondrive_torch.models.diffusion_head import UnetTrajectoryHead
from diffusiondrive_torch.utils.port_jax import load_jax_variables

from test_torch_port_variants import _close, _head_cfgs, _to64, seeded_variables, within_jax_bf16_accuracy


@pytest.fixture(scope="module")
def rollout_case():
    """The rollout tests' configs, inputs and weights, and JAX's float64
    rollout on them (op by op, once for the file)."""
    jcfg, pcfg = _head_cfgs()
    rng = np.random.default_rng(3)
    ego, status = (rng.normal(size=(2, 1, 256)).astype(np.float32) for _ in range(2))
    noise = rng.normal(size=(2, jcfg.num_poses, 3)).astype(np.float32)
    variables = seeded_variables(JUnetHead(jcfg), ego, status, noise=noise, seed=2)
    with jax.enable_x64(True):
        want64 = JUnetHead(jcfg, dtype=jnp.float64).apply(
            _to64(variables), *(a.astype(np.float64) for a in (ego, status)),
            noise=noise.astype(np.float64))["trajectory"]
        assert want64.dtype == jnp.float64
    return dict(jcfg=jcfg, pcfg=pcfg, ego=ego, status=status, noise=noise, variables=variables,
                want64=np.asarray(want64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unet_head_forward_test_given_noise_matches_jax(rollout_case, dtype):
    """`forward_test`: the full 20-step DDIM rollout ((950, ..., 0)) from the
    given (B, P, 3) noise, elementwise in float32 and float64. The rollout
    amplifies float32 differences step by step; float64 shows the
    arithmetic is the same."""
    c = rollout_case
    port = load_jax_variables(UnetTrajectoryHead(c["pcfg"], dtype), c["variables"]).to(dtype)
    with torch.no_grad():
        got = port.forward_test(*(torch.from_numpy(c[k]).to(dtype) for k in ("ego", "status")),
                                noise=torch.from_numpy(c["noise"]).to(dtype))["trajectory"].numpy()
    if dtype == torch.float64:
        want = c["want64"]
    else:
        want = JUnetHead(c["jcfg"]).apply(c["variables"], c["ego"], c["status"], noise=c["noise"])["trajectory"]
    assert got.shape == (2, 8, 3)
    _close(got, want, dtype, "unet rollout")


def test_unet_head_forward_test_in_bf16_within_jax_bf16_accuracy(rollout_case):
    """`forward_test` of the head at dtype bfloat16 (the UNet in bf16, the
    DDIM update promoted to float32, as JAX's) against JAX's head at dtype
    bfloat16 on the same weights and noise: a float32 trajectory in both,
    held to JAX's own bf16 accuracy (`within_jax_bf16_accuracy`: the
    20-step rollout carries each step's bf16 rounding into the next)."""
    c = rollout_case
    port = load_jax_variables(UnetTrajectoryHead(c["pcfg"], torch.bfloat16), c["variables"])
    with torch.no_grad():
        got = port.forward_test(*(torch.from_numpy(c[k]).bfloat16() for k in ("ego", "status")),
                                noise=torch.from_numpy(c["noise"]).bfloat16())["trajectory"]
    want = JUnetHead(c["jcfg"], dtype=jnp.bfloat16).apply(
        c["variables"], *(c[k].astype(jnp.bfloat16) for k in ("ego", "status")),
        noise=c["noise"].astype(jnp.bfloat16))["trajectory"]
    assert got.dtype == torch.float32 and want.dtype == jnp.float32 and got.shape == (2, 8, 3)
    within_jax_bf16_accuracy(got.numpy(), want, c["want64"], "unet rollout bf16")


def test_unet_head_forward_train_given_draws_matches_jax(monkeypatch):
    """`forward_train`: the GT trajectory noised at the given timesteps in
    [0, 1000) with the given (B, P, 3) noise (JAX's two draws fixed by a
    monkeypatch around its jit), clamped, the clean-sample prediction
    clamped and denormalised."""
    jcfg, pcfg = _head_cfgs()
    rng = np.random.default_rng(4)
    ego, status = (rng.normal(size=(3, 1, 256)).astype(np.float32) for _ in range(2))
    traj = np.stack([rng.uniform(0, 40, (3, 8)), rng.normal(0, 3, (3, 8)), rng.normal(0, 0.3, (3, 8))],
                    -1).astype(np.float32)
    timesteps = np.array([0, 517, 999], np.int32)
    noise = rng.normal(size=(3, 8, 3)).astype(np.float32)
    head = JUnetHead(jcfg)
    variables = seeded_variables(head, ego, status, noise=noise, seed=5)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(timesteps))
        mp.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(noise))
        want = jax.jit(lambda v: head.apply(v, ego, status, targets={"trajectory": traj}, train=True,
                                            rngs={"diffusion": jax.random.PRNGKey(0)}))(variables)["trajectory"]
    port = load_jax_variables(UnetTrajectoryHead(pcfg), variables)
    with torch.no_grad():
        got = port.forward_train(torch.from_numpy(ego), torch.from_numpy(status),
                                 {"trajectory": torch.from_numpy(traj)}, timesteps=torch.from_numpy(timesteps).long(),
                                 noise=torch.from_numpy(noise))["trajectory"].numpy()
    _close(got, want, name="unet forward_train")
    # its own draws: timesteps in [0, 1000) first, then (B, P, 3) noise
    t, n = port.train_draws(5, torch.Generator().manual_seed(0))
    assert t.shape == (5,) and 0 <= int(t.min()) and int(t.max()) < 1000 and n.shape == (5, 8, 3)
    assert port.draw_noise(2).shape == (2, 8, 3) and port.noise_shape == (8, 3) and port.train_max_t == 1000
