"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: skips without a GPU. The file imports torch only (no JAX), so
it runs on a machine without JAX; run it there with
``python -m pytest tests/test_torch_port_cuda.py -m cuda -q --noconftest -o addopts=""``.
"""

import pytest
import torch

from diffusiondrive_torch.models.resnet import ResNetStem
from diffusiondrive_torch.ops.conv_fused import conv3x3_plain, fused_conv3x3, to_hwio
from diffusiondrive_torch.ops.stem_fused import fused_stem, stem_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: python -m pytest -m cuda)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, tol):
    """On the card: each kernel against its plain version at odd edges
    (H, W not multiples of the tiles). bf16 tolerance: the plain version
    rounds the conv to bf16 before the affine, the kernel does not."""
    g = torch.Generator().manual_seed(0)
    s, b = torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g) * 0.1
    for C in (1, 3):
        x = torch.randn(2, 36, 100, C, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2)
        w = torch.randn(64, C, 7, 7, generator=g) * 0.1
        args = (to_hwio(w.to(cuda_device), dtype), s.to(cuda_device), b.to(cuda_device))
        got, want = fused_stem(x, *args).float(), stem_plain(x, *args).float()
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    x = torch.randn(2, 20, 36, 64, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2)
    r = torch.randn(2, 20, 36, 64, generator=g).to(cuda_device, dtype).permute(0, 3, 1, 2)
    w = to_hwio((torch.randn(64, 64, 3, 3, generator=g) * 0.05).to(cuda_device), dtype)
    for res, relu in ((None, False), (r, True)):
        got = fused_conv3x3(x, w, s.to(cuda_device), b.to(cuda_device), res, relu).float()
        want = conv3x3_plain(x, w, s.to(cuda_device), b.to(cuda_device), res, relu).float()
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_stem_with_unsupported_shape_raises(cuda_device):
    """On the card the eval stem launches the kernel or raises: no plain path."""
    stem = ResNetStem(5).to(cuda_device).eval()
    with torch.no_grad(), pytest.raises(ValueError, match="not supported"):
        stem(torch.zeros(1, 5, 64, 64, device=cuda_device))
