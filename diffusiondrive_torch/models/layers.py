"""Shared building blocks (counterpart of `diffusiondrive_tpu/models/layers.py`).

dtype policy, as Flax's ``param_dtype=float32, dtype=<compute type>``:
parameters and BatchNorm statistics stay float32 and are cast to the
module's compute `dtype` at use; LayerNorm and softmax statistics are taken
in float32. Module attribute names are the Flax scope names, so a Flax
variable tree maps onto the `state_dict` mechanically (`utils/port_jax.py`).

Flax's LayerNorm uses eps 1e-6 (torch's default is 1e-5); every LayerNorm
here takes 1e-6.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusiondrive_torch.ops.conv_fused import bn_eval_affine

LN_EPS = 1e-6
BN_EPS = 1e-5


class Linear(nn.Linear):
    """`nn.Linear` with float32 parameters that computes in `dtype` (Flax `nn.Dense`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` with float32 parameters that computes in `dtype` (Flax `nn.Conv`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


class LayerNorm(nn.LayerNorm):
    """Flax-convention LayerNorm: eps 1e-6, statistics in float32, output in `dtype`."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5, Flax momentum 0.9 == torch momentum 0.1) over an
    NCHW input in `dtype`, with float32 parameters and statistics."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=BN_EPS, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.compute_dtype))

    def eval_affine(self):
        """Exact float32 (scale, bias) of this BatchNorm in eval mode."""
        return bn_eval_affine(self.weight, self.bias, self.running_mean, self.running_var, self.eps)


def softmax_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax with float32 statistics, returned in `x`'s dtype."""
    return torch.softmax(x, dim=dim, dtype=torch.float32).to(x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation: x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections; dropout is eval-only (none)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(d_model, d_model, dtype=dtype)
        self.k_proj = Linear(d_model, d_model, dtype=dtype)
        self.v_proj = Linear(d_model, d_model, dtype=dtype)
        self.out_proj = Linear(d_model, d_model, dtype=dtype)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        B, Tq, C = q_in.shape
        d_head = C // self.num_heads

        def split(x):
            return x.reshape(B, x.shape[1], self.num_heads, d_head).transpose(1, 2)

        q, k, v = split(self.q_proj(q_in)), split(self.k_proj(k_in)), split(self.v_proj(v_in))
        att = softmax_f32((q @ k.transpose(-2, -1)) / math.sqrt(d_head))
        y = (att @ v).transpose(1, 2).reshape(B, Tq, C)
        return self.out_proj(y)


class TransformerDecoderLayer(nn.Module):
    """torch `nn.TransformerDecoderLayer` semantics: post-LN, ReLU FFN."""

    def __init__(self, d_model: int, num_heads: int, d_ffn: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype)
        self.norm1 = LayerNorm(d_model, dtype)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = self.norm1(tgt + self.self_attn(tgt, tgt, tgt))
        x = self.norm2(x + self.cross_attn(x, memory, memory))
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


class TransformerDecoder(nn.Module):
    """Stack of `TransformerDecoderLayer`s named layer0..layerN-1 (no final norm)."""

    def __init__(self, d_model: int, num_heads: int, d_ffn: int, num_layers: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerDecoderLayer(d_model, num_heads, d_ffn, dtype))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = tgt
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, memory)
        return x


class LinearReluLn(nn.Module):
    """``linear_relu_ln``: out_loops x [in_loops x (Linear + ReLU), LayerNorm],
    with Flax names dense_{o}_{i} and ln_{o}."""

    def __init__(self, in_dims: int, embed_dims: int, in_loops: int = 1, out_loops: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_loops, self.out_loops = in_loops, out_loops
        dims = in_dims
        for o in range(out_loops):
            for i in range(in_loops):
                self.add_module(f"dense_{o}_{i}", Linear(dims, embed_dims, dtype=dtype))
                dims = embed_dims
            self.add_module(f"ln_{o}", LayerNorm(embed_dims, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for o in range(self.out_loops):
            for i in range(self.in_loops):
                x = F.relu(getattr(self, f"dense_{o}_{i}")(x))
            x = getattr(self, f"ln_{o}")(x)
        return x


def flax_default_init_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every parameter of `module` from `generator` in place.

    Weights ~ N(0, 1/fan_in) (lecun-normal scale), biases 0, norm weights 1,
    free embeddings ~ N(0, 1); buffers are left as they are.
    """
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
            if isinstance(owner, (nn.LayerNorm, nn.BatchNorm2d)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "weight":
                fan_in = p[0].numel()
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            else:  # pos_emb, keyval_embedding, query_embedding
                p.normal_(0.0, 1.0, generator=generator)
