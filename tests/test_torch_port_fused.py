"""Port parity of the opt-in training kernels: fused attention and conv3x3_train.

The JAX package's Pallas kernels run in interpret mode (`interpret=True`,
`fused_mode="interpret"`, `fused_attention_mode="interpret"`), as
`tests/test_attention_fused.py` and `tests/test_conv_fused.py` run them;
the port's wrappers run their plain versions on the CPU. Inputs come from
numpy seeds and go to both packages. The CUDA kernels themselves are held
against these plain versions on the card by `tests/test_torch_port_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiondrive_tpu.models.backbone import GPTFusion as JGPTFusion
from diffusiondrive_tpu.models.config import TransfuserConfig as JConfig
from diffusiondrive_tpu.models.resnet import BasicBlock as JBasicBlock
from diffusiondrive_tpu.ops import attention_fused as jattn
from diffusiondrive_tpu.ops.conv_fused import conv3x3_train as j_conv3x3_train

from diffusiondrive_torch.entry import build_model, comparison_batch, grad_distances, train_step_on
from diffusiondrive_torch.models.backbone import GPTFusion
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.layers import set_dropout_generator
from diffusiondrive_torch.models.resnet import BasicBlock, ResNetStem
from diffusiondrive_torch.ops import attention_fused, conv_fused, stem_fused
from diffusiondrive_torch.ops.attention_fused import (
    backward_kernel, dropout_keep_mask, forward_kernel, fused_attention, supports_fused_attention)
from diffusiondrive_torch.ops.conv_fused import conv3x3_train, fused_conv3x3
from diffusiondrive_torch.utils.port_jax import jax_params_to_named, load_jax_variables


def _counting(monkeypatch, module, name):
    """Count calls of `module.name` (the plain version a CPU tensor takes)."""
    calls = [0]
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _qkvm(shape, seed, masked, dtype=np.float32):
    B, H, T, D = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=shape).astype(dtype) for _ in range(4))
    mask = (rng.uniform(size=(B, H, T, T)) >= 0.25).astype(np.uint8) if masked else None
    return q, k, v, do, mask


def _port(a, dtype=torch.float32):
    """numpy -> torch; the float arrays in `dtype`, a uint8 mask as it is."""
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t if a.dtype == np.uint8 else t.to(dtype)


def _jax(a, dtype=jnp.float32):
    if a is None:
        return None
    return jnp.asarray(a) if a.dtype == np.uint8 else jnp.asarray(a, dtype)


SHAPES = [(3, 2, 24, 32), (2, 4, 320, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_attention_forward_matches_jax_interpret(shape, masked):
    """(a) float32 at the JAX test's tolerance (sums in another order)."""
    q, k, v, _, mask = _qkvm(shape, 0, masked)
    pdrop = 0.25 if masked else 0.0
    want = jattn.fused_attention(*map(_jax, (q, k, v, mask)), pdrop, True)
    got = fused_attention(*map(_port, (q, k, v, mask)), pdrop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _grads_both(shape, masked, jdt, tdt):
    q, k, v, do, mask = _qkvm(shape, 1, masked)
    pdrop = 0.25 if masked else 0.0
    jq, jk, jv, jdo = (_jax(a, jdt) for a in (q, k, v, do))
    jm = _jax(mask)

    def loss(q_, k_, v_):
        return jnp.sum((jattn.fused_attention(q_, k_, v_, jm, pdrop, True) * jdo).astype(jnp.float32))

    jout = jattn.fused_attention(jq, jk, jv, jm, pdrop, True)
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [_port(a, tdt).requires_grad_() for a in (q, k, v)]
    out = fused_attention(*leaves, _port(mask), pdrop)
    out.backward(_port(do, tdt))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return ([out.detach().float().numpy()] + [t.grad.float().numpy() for t in leaves],
            [f32(jout)] + [f32(g) for g in want])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_attention_gradients_match_jax_custom_vjp(shape, masked, monkeypatch):
    """(b) dq, dk, dv of the port's autograd Function (its backward is the
    backward kernel's plain version on the CPU) against `jax.grad` through
    the JAX custom VJP (the Pallas backward kernel, interpreted), 1e-4."""
    bwd = _counting(monkeypatch, attention_fused, "attention_bwd_plain")
    got, want = _grads_both(shape, masked, jnp.float32, torch.float32)
    assert bwd[0] == 1
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_attention_bf16_matches_jax_within_two_ulps(shape, masked):
    """(c) bf16 on both sides: both round p to bf16 before p . v and the
    score gradient before the dq and dk products, at the same places; a
    last-bit float32 difference before a rounding can flip it by one bf16
    ulp, and the result's own rounding by one more: within 2 bf16 ulps
    (2 * 2^-8) of max |out| for the output and each gradient."""
    got, want = _grads_both(shape, masked, jnp.bfloat16, torch.bfloat16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        limit = 2.0 * 2.0 ** -8 * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= limit, (name, err, limit)


def test_gate_equals_jax():
    """(d) `supports_fused_attention` is JAX's gate over a grid of (T, D)."""
    for T in range(0, 530, 4):
        for D in (0, 4, 7, 8, 9, 16, 33, 64, 128, 255, 256, 257, 512):
            assert supports_fused_attention(T, D) == jattn.supports_fused_attention(T, D), (T, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_names_follow_the_dispatch_rule(dtype):
    """`forward_kernel` and `backward_kernel` name what `dispatch` in
    `csrc/attention_fused.cu` launches over a grid of head widths: the
    tensor cores ("mma") for bf16 with D up to the source's bound in both
    directions, the CUDA cores for float32 and wider bf16 heads."""
    import re
    from pathlib import Path

    src = (Path(attention_fused.__file__).resolve().parent.parent / "csrc" / "attention_fused.cu").read_text()
    # bf16: one head-width ladder `mma(Int<DP>())` whose lambda takes either direction
    assert re.search(r"backward \? bwd_mma<[^>]+>\(a, s\) : fwd_mma<[^>]+>\(a, s\)", src)
    mma_bound = max(int(n) for n in re.findall(r"if \(a\.D <= (\d+)\) return mma\(", src))
    bounds = {"forward": mma_bound, "backward": mma_bound}
    assert bounds == {"forward": 128, "backward": 128}
    for D in (8, 16, 32, 33, 48, 64, 127, 128, 129, 192, 256):
        for direction, name in (("forward", forward_kernel), ("backward", backward_kernel)):
            want = "mma" if dtype == torch.bfloat16 and D <= bounds[direction] else "cuda_core"
            assert name(dtype, D) == want, (direction, dtype, D)


def _fusion_configs(attn_pdrop=0.0, **kw):
    """A GPT fusion config with T = 2*8 + 2*4 = 24 tokens (a multiple of 8)."""
    common = dict(img_vert_anchors=2, img_horz_anchors=8, lidar_vert_anchors=2, lidar_horz_anchors=4,
                  n_head=4, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=attn_pdrop)
    return JConfig(fused_attention_mode="interpret", **common), TransfuserConfig(**{**common, **kw})


def test_gpt_fusion_on_matches_jax_interpret(monkeypatch):
    """(e) `GPTFusion` with "on" against JAX `GPTFusion` with "interpret":
    the weights carried by `utils/port_jax.py`, dropout off; the forward
    and every parameter's gradient at 1e-4, the fused path taken in both
    blocks, forward and backward."""
    jcfg, cfg = _fusion_configs(fused_attention_mode="on")
    C, B = 64, 2
    rng = np.random.default_rng(3)
    img = rng.normal(size=(B, 2, 8, C)).astype(np.float32)
    lid = rng.normal(size=(B, 2, 4, C)).astype(np.float32)
    ct_img = rng.normal(size=img.shape).astype(np.float32)
    ct_lid = rng.normal(size=lid.shape).astype(np.float32)
    jmod = JGPTFusion(C, jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), img, lid))
    variables["params"]["pos_emb"] = rng.normal(size=(1, 24, C)).astype(np.float32) * 0.1

    def loss(params):
        oi, ol = jmod.apply({"params": params}, img, lid, True)
        return jnp.sum(oi * ct_img) + jnp.sum(ol * ct_lid), (oi, ol)

    jgrads, (joi, jol) = jax.grad(loss, has_aux=True)(variables["params"])
    fwd = _counting(monkeypatch, attention_fused, "attention_fwd_plain")
    bwd = _counting(monkeypatch, attention_fused, "attention_bwd_plain")
    model = load_jax_variables(GPTFusion(C, cfg), variables).eval()
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    oi, ol = model(nchw(img), nchw(lid))
    (torch.sum(oi * nchw(ct_img)) + torch.sum(ol * nchw(ct_lid))).backward()
    assert (fwd[0], bwd[0]) == (2, 2)
    np.testing.assert_allclose(oi.detach().permute(0, 2, 3, 1).numpy(), np.asarray(joi), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ol.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jol), rtol=1e-4, atol=1e-4)
    want = jax_params_to_named(jax.tree_util.tree_map(np.asarray, jgrads), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4, err_msg=name)


def test_on_and_auto_draw_the_same_dropout():
    """(f) Train mode, attn_pdrop 0.25 (and live token and residual
    dropouts): "on" and "auto" on one seeded generator give the same output
    within 1e-5 and leave the generator in the same state."""
    _, cfg_on = _fusion_configs(0.25, fused_attention_mode="on", embd_pdrop=0.1, resid_pdrop=0.1)
    _, cfg_auto = _fusion_configs(0.25, embd_pdrop=0.1, resid_pdrop=0.1)
    torch.manual_seed(0)
    models = {"on": GPTFusion(64, cfg_on), "auto": GPTFusion(64, cfg_auto)}
    models["auto"].load_state_dict(models["on"].state_dict())
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.normal(size=(2, 64, 2, 8)).astype(np.float32))
    lid = torch.from_numpy(rng.normal(size=(2, 64, 2, 4)).astype(np.float32))
    outs, states = {}, {}
    for name, m in models.items():
        gen = torch.Generator().manual_seed(11)
        set_dropout_generator(m, gen)
        outs[name] = m.train()(img, lid)
        states[name] = gen.get_state()
    for a, b in zip(outs["on"], outs["auto"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(states["on"], states["auto"])
    # the mask is the one `Dropout` draws: same draws, same rate
    gen = torch.Generator().manual_seed(5)
    mask = dropout_keep_mask(gen, (2, 4, 24, 24), 0.25, torch.device("cpu"))
    keep = torch.rand((2, 4, 24, 24), generator=torch.Generator().manual_seed(5)) >= 0.25
    assert mask.dtype == torch.uint8 and torch.equal(mask.bool(), keep)


def test_conv3x3_train_matches_jax_interpret(monkeypatch):
    """(g) value, dx and dw against JAX `conv3x3_train(..., True)` at
    (2, 8, 16, 64), 1e-4 (sums in another order); the forward and dx take
    the kernel's wrapper (its plain version on the CPU)."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(2, 8, 16, 64)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(3, 3, 64, 64)) * 0.2).astype(np.float32)
    ct = rng.normal(size=(2, 8, 16, 64)).astype(np.float32)

    def loss(x_, w_):
        y = j_conv3x3_train(x_, w_, True)
        return jnp.sum(y * ct), y

    (jdx, jdw), jy = jax.grad(loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    calls = _counting(monkeypatch, conv_fused, "conv3x3_plain")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv3x3_train(xt, wt)
    y.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    assert calls[0] == 2
    for name, got, want in (("y", y.detach().permute(0, 2, 3, 1), jy), ("dx", xt.grad.permute(0, 2, 3, 1), jdx),
                            ("dw", wt.grad, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4, err_msg=name)


def test_basic_block_train_mode_matches_jax_interpret(monkeypatch):
    """(h) `BasicBlock` with "train" against JAX `BasicBlock(fused_mode=
    "interpret")` in train mode: output, parameter and input gradients and
    the updated batch statistics, 1e-4; both convs go through
    `conv3x3_train` (2 forwards and 2 input gradients)."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 8, 16, 64)) * 0.5).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    jblk = JBasicBlock(64, fused_mode="interpret")
    variables = jax.tree_util.tree_map(np.asarray, jblk.init(jax.random.PRNGKey(0), x, train=False))
    variables["batch_stats"] = jax.tree_util.tree_map(lambda a: a + 0.3, variables["batch_stats"])

    def loss(params, x_):
        y, mut = jblk.apply({"params": params, "batch_stats": variables["batch_stats"]}, x_, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, mut["batch_stats"])

    (jgp, jgx), (jy, jstats) = jax.grad(loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    calls = _counting(monkeypatch, conv_fused, "conv3x3_plain")
    blk = load_jax_variables(BasicBlock(64, 64, fused_mode="train"), variables).train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = blk(xt)
    y.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    assert calls[0] == 4
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    want = jax_params_to_named(jax.tree_util.tree_map(np.asarray, jgp), blk)
    for name, p in blk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    for bn in ("bn1", "bn2"):
        np.testing.assert_allclose(getattr(blk, bn).running_mean.numpy(), np.asarray(jstats[bn]["mean"]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(getattr(blk, bn).running_var.numpy(), np.asarray(jstats[bn]["var"]),
                                   rtol=1e-4, atol=1e-4)


def test_config_switches_validate_and_off_takes_the_module_path(monkeypatch):
    """(i) Only the JAX package's values are accepted; "off" in eval mode
    runs no stem or conv3x3 kernel (its plain version is not reached) and
    gives the eval kernels' result; "train" in eval runs them."""
    for kw in ({"fused_conv_mode": "on"}, {"fused_conv_mode": "TRAIN"}, {"fused_attention_mode": "off"},
               {"fused_attention_mode": "train"}):
        with pytest.raises(ValueError, match="fused_"):
            TransfuserConfig(**kw)
    for conv in ("auto", "off", "train", "interpret"):
        for attn in ("auto", "on", "interpret"):
            TransfuserConfig(fused_conv_mode=conv, fused_attention_mode=attn)
    stem_calls = _counting(monkeypatch, stem_fused, "stem_plain")
    conv_calls = _counting(monkeypatch, conv_fused, "conv3x3_plain")
    torch.manual_seed(0)
    x = torch.randn(2, 64, 8, 12)
    img = torch.randn(1, 3, 64, 128)
    outs = {}
    for mode in ("off", "train"):
        torch.manual_seed(1)
        blk, stem = BasicBlock(64, 64, fused_mode=mode).eval(), ResNetStem(3, fused_mode=mode).eval()
        before = (stem_calls[0], conv_calls[0])
        with torch.no_grad():
            outs[mode] = (blk(x), stem(img))
        assert (stem_calls[0] - before[0], conv_calls[0] - before[1]) == ((0, 0) if mode == "off" else (1, 2))
    for a, b in zip(outs["off"], outs["train"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_switched_train_step_matches_default_step(monkeypatch):
    """(j) One train step of a small model on the CPU with both switches
    ("train", "on") against the default step, same weights and batch:
    every loss term and parameter gradient within 1e-4 relative. In float64,
    so that the comparison reads the algorithm: two summation orders of the
    same conv in float32 can put a ReLU on either side of its kink and move
    the gradients behind it (PERF.md, §6). The switched step runs the
    fused attention in all 8 blocks (4 stages x 2 layers, forward and
    backward) and `conv3x3_train` in the 8 layer-1 convs (forward and dx)."""
    # T = 2 * 6 image + 2 * 2 lidar tokens = 16, a multiple of 8
    small = dict(image_architecture="resnet18", lidar_architecture="resnet18", camera_height=64,
                 camera_width=192, lidar_resolution_height=64, lidar_resolution_width=64,
                 img_vert_anchors=2, img_horz_anchors=6, lidar_vert_anchors=2, lidar_horz_anchors=2,
                 bev_pixel_height=32, bev_pixel_width=64)
    cfg = TransfuserConfig(**small)
    cfg_on = TransfuserConfig(fused_conv_mode="train", fused_attention_mode="on", **small)
    model = build_model(cfg, seed=0).train()
    batch, ts, noise = comparison_batch(model, cfg, 2, seed=0)
    base = train_step_on(model, cfg, batch, ts, noise, "cpu", torch.float64)
    calls = {name: _counting(monkeypatch, mod, name) for mod, name in (
        (attention_fused, "attention_fwd_plain"), (attention_fused, "attention_bwd_plain"),
        (conv_fused, "conv3x3_plain"))}
    # a float64 step builds its model from the config it is given: the same weights, switched
    switched = train_step_on(model, cfg_on, batch, ts, noise, "cpu", torch.float64)
    assert {k: v[0] for k, v in calls.items()} == {
        "attention_fwd_plain": 8, "attention_bwd_plain": 8, "conv3x3_plain": 16}
    for k, v in base["losses"].items():
        assert abs(switched["losses"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
    dist = grad_distances(switched["grads"], base["grads"])
    worst = max(dist, key=dist.get)
    assert dist[worst] <= 1e-4, (worst, dist[worst])
    assert fused_conv3x3.launches == 0 and fused_attention.launches == 0  # the CPU launches nothing
