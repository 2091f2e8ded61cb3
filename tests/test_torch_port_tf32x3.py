"""The float32 attention kernels' arithmetic (3xTF32), modelled on the CPU.

On the card `csrc/attention_fused.cu` runs float32 attention on the tensor
cores, three TF32 products a product: each operand x is split into big = x
rounded to TF32 (10 explicit mantissa bits, to nearest, ties away from zero:
the value of `cvt.rna.tf32.f32`) and small = x - big, which the mma reads as
TF32 by truncation (`ddt::split_tf32`); a product is big·big + big·small +
small·big, accumulated in float32. Here that arithmetic is written in plain
torch and held against the JAX package's float32 `fused_attention` (its
Pallas kernel in interpret mode) within the port's float32 limit, 1e-4 x
max(1, |JAX|), at the fused tests' head widths 32 and 256. One TF32 product
alone breaks that limit: why the kernels take three.
"""

import numpy as np
import pytest
import torch

from diffusiondrive_tpu.ops import attention_fused as jattn

SHAPES = [(3, 2, 24, 32), (1, 2, 24, 256)]  # as `tests/test_torch_port_fused.py`: D = 32, ResNet-50's 256
PDROP = 0.25


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 to nearest, ties away from zero: half a TF32 ulp added
    to the magnitude bits, the 13 low bits cleared (finite x)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 toward zero, as the mma reads a float32 operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, small_tf32=tf32_truncate) -> torch.Tensor:
    """a @ b from split operands: big·big + big·small + small·big in float32.
    Every elementwise product of two TF32 values is exact in float32, so
    float32 matmuls accumulate them as the mma does, in another order."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = small_tf32(a - ab), small_tf32(b - bb)
    return torch.matmul(as_, bb) + torch.matmul(ab, bs) + torch.matmul(ab, bb)


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def attention_model(q, k, v, mask, matmul) -> torch.Tensor:
    """softmax(q kᵀ / √D) in float32, the keep mask times 1/(1 - p), · v, with
    both products taken by `matmul`."""
    s = matmul(q, k.transpose(-2, -1)) * (1.0 / np.sqrt(q.shape[-1]))
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = torch.where(mask != 0, p * (1.0 / (1.0 - PDROP)), torch.zeros(()))
    return matmul(p, v)


def test_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    """Ten explicit mantissa bits kept; exact halves move away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23, 1.0 + 3 * ulp / 2, 3.0],
                     dtype=torch.float32)
    want = [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0]
    assert tf32_rna(x).tolist() == want
    assert tf32_truncate(torch.tensor([1.0 + ulp - 2.0 ** -23])).tolist() == [1.0]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("small", ["truncated", "rounded"])
def test_3xtf32_forward_holds_the_float32_limit_against_jax(shape, masked, small):
    """The 3xTF32 forward (small part truncated, as the kernels take it, or
    rounded too) within 1e-4 x max(1, |JAX|) of JAX's float32 forward; one
    TF32 product past it."""
    B, H, T, D = shape
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(B, H, T, T)) >= PDROP).astype(np.uint8) if masked else None
    want = np.asarray(jattn.fused_attention(q, k, v, mask, PDROP if masked else 0.0, True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    small_tf32 = tf32_truncate if small == "truncated" else tf32_rna
    got3 = attention_model(tq, tk, tv, tm, lambda a, b: matmul_3xtf32(a, b, small_tf32)).numpy()
    got1 = attention_model(tq, tk, tv, tm, matmul_1xtf32).numpy()
    limit = 1e-4 * max(1.0, float(np.abs(want).max()))
    err3, err1 = float(np.abs(got3 - want).max()), float(np.abs(got1 - want).max())
    assert err3 <= limit, (err3, limit)
    assert err1 > limit, (err1, limit)
