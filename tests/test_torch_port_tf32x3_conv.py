"""The float32 conv3x3 and stem kernels' arithmetic (3xTF32), modelled on the CPU.

On the card `csrc/conv3x3_fused.cu` and `csrc/stem_fused.cu` run float32 on
the tensor cores, three TF32 products a product, as the float32 attention
does (`tests/test_torch_port_tf32x3.py`): each operand x is split into
big = x rounded to TF32 (to nearest, ties away from zero) and small =
x - big, which the mma reads as TF32 by truncation; a product is
small·big + big·small + big·big, accumulated in float32. Here that
arithmetic is written in plain torch around the two kernels' own forms
(the 3x3 conv; the stem's 4x4/s1 conv over the 2x2 space-to-depth of its
input, `stem_conv_s2d`, whose zero channels past the float32 kernel's 4C
add exact zeros) and held
against the JAX package's float32 `fused_conv3x3` and `fused_stem` (their
Pallas kernels in interpret mode) within the port's float32 limit, 1e-4 x
max(1, |JAX|). One TF32 product alone breaks that limit, or lands at least
10x further off than three: why the kernels take three.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusiondrive_tpu.ops.conv_fused import fused_conv3x3 as j_fused_conv3x3
from diffusiondrive_tpu.ops.stem_fused import fused_stem as j_fused_stem

from diffusiondrive_torch.ops.stem_fused import stem_conv_s2d
from test_torch_port_tf32x3 import tf32_rna, tf32_truncate


def products_3xtf32(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`op(a, b)`, bilinear, from split operands as `matmul_3xtf32` takes a
    matmul: small·big + big·small + big·big in float32. A convolution's
    products of two TF32 values are exact in float32, so float32 sums
    accumulate them as the mma does, in another order."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = tf32_truncate(a - ab), tf32_truncate(b - bb)
    return op(as_, bb) + op(ab, bs) + op(ab, bb)


def products_1xtf32(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return op(tf32_rna(a), tf32_rna(b))


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _errors(model, want: np.ndarray):
    """(3xTF32 error, 1xTF32 error, the limit 1e-4 x max(1, |want|))."""
    got3, got1 = (model(p).permute(0, 2, 3, 1).numpy() for p in (products_3xtf32, products_1xtf32))
    limit = 1e-4 * max(1.0, float(np.abs(want).max()))
    return float(np.abs(got3 - want).max()), float(np.abs(got1 - want).max()), limit


@pytest.mark.parametrize("residual,relu", [(False, False), (False, True), (True, True)])
def test_3xtf32_conv3x3_holds_the_float32_limit_against_jax(residual, relu):
    """The 3x3/s1/pad1 conv in 3xTF32, then the float32 affine, residual and
    ReLU, against JAX's float32 `fused_conv3x3(interpret=True)` at
    `tests/test_torch_port_kernels.py`'s shape; one TF32 product past the
    limit or 10x further off."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 16, 32, 64)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 64, 64)) / 24.0).astype(np.float32)  # HWIO, as `chip_smoke.py` draws it
    sc = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bi = rng.normal(size=64).astype(np.float32)
    res = rng.normal(size=x.shape).astype(np.float32) if residual else None
    want = np.asarray(j_fused_conv3x3(x, w, sc, bi, residual=res, relu=relu, interpret=True))

    def model(products):
        conv = products(lambda a, b: F.conv2d(a, b.permute(3, 2, 0, 1), padding=1), _nchw(x), torch.from_numpy(w))
        y = conv * torch.from_numpy(sc)[:, None, None] + torch.from_numpy(bi)[:, None, None]
        if res is not None:
            y = y + _nchw(res)
        return torch.relu(y) if relu else y

    err3, err1, limit = _errors(model, want)
    assert err3 <= limit, (err3, limit)
    assert err1 > limit or err1 >= 10 * err3, (err1, err3, limit)


@pytest.mark.parametrize("C", [1, 3])
def test_3xtf32_stem_in_its_s2d_form_holds_the_float32_limit_against_jax(C):
    """The stem's conv as the float32 kernel takes it, a 4x4/s1 conv over
    the 2x2 space-to-depth of the input, in 3xTF32; then
    the float32 affine, ReLU and 3x3/s2 max-pool; against JAX's float32
    `fused_stem(interpret=True)` at (1, 64, 512, C), the smallest shape
    JAX's gate takes (the lidar C = 1, the camera C = 3); one TF32 product
    past the limit or 10x further off."""
    rng = np.random.default_rng(13 + C)
    x = rng.normal(size=(1, 64, 512, C)).astype(np.float32)
    w = (rng.normal(size=(7, 7, C, 64)) / (49 * C) ** 0.5).astype(np.float32)  # HWIO
    sc = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    bi = (rng.normal(size=64) * 0.1).astype(np.float32)
    want = np.asarray(j_fused_stem(x, w, sc, bi, interpret=True))

    def model(products):
        conv = products(lambda a, b: stem_conv_s2d(a, b), _nchw(x), torch.from_numpy(w))
        y = torch.relu(conv * torch.from_numpy(sc)[:, None, None] + torch.from_numpy(bi)[:, None, None])
        return F.max_pool2d(y, 3, stride=2, padding=1)

    err3, err1, limit = _errors(model, want)
    assert err3 <= limit, (err3, limit)
    assert err1 > limit or err1 >= 10 * err3, (err1, err3, limit)


def _truncated_to_float32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 value next to it toward zero."""
    f = v.float()
    f = torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def test_3xtf32_split_is_float32_accurate_and_truncating_sums_are_not():
    """Where the card's float32 conv3x3 loses accuracy. Its 3xTF32 products
    summed in IEEE float32 lie as close to float64 as a plain float32 conv
    (relative L2, within 2x); summed as the tensor cores sum them, into a
    float32 accumulator cut toward zero after each m16n8k8 product (three a
    k-step of 8), they lie at least 5x further off: the kernel's 4.2e-6
    against cuDNN's 4.5e-7 on the layer-1 convs of a float32 train step
    (`run_kinks.py`), far inside the 1e-4 limit."""
    g = torch.Generator().manual_seed(3)
    x = torch.relu(torch.randn(1, 64, 16, 32, generator=g))
    w = torch.randn(64, 64, 3, 3, generator=g) / 24.0
    ref = F.conv2d(x.double(), w.double(), padding=1)

    def rel_l2(y):
        return float((y.double() - ref).norm() / ref.norm())

    conv = lambda a, b: F.conv2d(a, b, padding=1)  # noqa: E731
    err_f32, err_split = rel_l2(conv(x, w)), rel_l2(products_3xtf32(conv, x, w))
    cols = F.unfold(x, 3, padding=1)[0].t()  # (pixels, 576)
    wk = w.reshape(64, -1).t()                # (576, 64)
    a_big, b_big = tf32_rna(cols), tf32_rna(wk)
    parts = [(tf32_truncate(cols - a_big), b_big), (a_big, tf32_truncate(wk - b_big)), (a_big, b_big)]
    acc = torch.zeros(cols.shape[0], 64, dtype=torch.float64)
    for k in range(0, cols.shape[1], 8):
        for a, b in parts:
            acc = _truncated_to_float32(acc + a[:, k:k + 8].double() @ b[k:k + 8].double())
    err_cut = rel_l2(acc.t().reshape(ref.shape))
    assert err_split <= 2 * err_f32, (err_split, err_f32)
    assert err_cut >= 5 * err_split, (err_cut, err_split)
