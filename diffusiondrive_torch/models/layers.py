"""Shared building blocks (counterpart of `diffusiondrive_tpu/models/layers.py`).

dtype policy, as Flax's ``param_dtype=float32, dtype=<compute type>``:
parameters and BatchNorm statistics stay float32 and are cast to the
module's compute `dtype` at use; LayerNorm and softmax statistics are taken
in float32 (in float64 when the compute type is float64: a model built with
`dtype=torch.float64` and moved to float64 computes every step in float64,
the reference a float32 run is measured against). Module attribute names are
the Flax scope names, so a Flax variable tree maps onto the `state_dict`
mechanically (`utils/port_jax.py`).

Flax's LayerNorm uses eps 1e-6 (torch's default is 1e-5); every LayerNorm
here takes 1e-6. BatchNorm follows Flax in train mode too (biased batch
variance, momentum 0.9). Dropout is live in train mode only and draws from
a generator the model sets per step (`set_dropout_generator`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusiondrive_torch.ops.conv_fused import bn_eval_affine
from diffusiondrive_torch.parallel.distributed import all_reduce_sum, world_size

LN_EPS = 1e-6
BN_EPS = 1e-5


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The type statistics of `x` are taken in: float32, float64 for a float64 `x`."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


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


class Conv1d(nn.Conv1d):
    """`nn.Conv1d` over (B, C, T) with float32 parameters that computes in
    `dtype` (Flax's 1-D `nn.Conv`, whose (k, in, out) kernel is this
    module's (out, in, k) weight)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d), self.bias.to(d))


class ConvTranspose1d(nn.ConvTranspose1d):
    """`nn.ConvTranspose1d` over (B, C, T) with float32 parameters that
    computes in `dtype`. Flax's ``nn.ConvTranspose((k,), strides=(s,),
    padding=((k - 1 - p, k - 1 - p),))`` is this module with padding `p`;
    its (k, in, out) kernel is this module's (in, out, k) weight with the
    taps reversed (`utils/port_jax.py`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.conv_transpose1d(x.to(d), self.weight.to(d), self.bias.to(d), self.stride, self.padding)


class GroupNorm(nn.Module):
    """Flax `nn.GroupNorm(num_groups, epsilon)` over (B, C, T): per sample
    and group, the mean and the variance E[x^2] - E[x]^2 (clamped at 0)
    taken in float32 (float64 for float64 input), ``(x - mean) * (rsqrt(var
    + eps) * scale) + bias`` in that type, the output in `dtype`."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups, self.eps, self.compute_dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        xf = x.to(stat_dtype(x))
        g = xf.reshape(B, self.num_groups, C // self.num_groups, T)
        mean = g.mean((2, 3))
        var = torch.clamp_min((g * g).mean((2, 3)) - mean * mean, 0.0)
        mean = mean.repeat_interleave(C // self.num_groups, 1)[:, :, None]
        var = var.repeat_interleave(C // self.num_groups, 1)[:, :, None]
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None].to(xf.dtype)
        y = (xf - mean) * mul + self.bias[:, None].to(xf.dtype)
        return y.to(self.compute_dtype)


class Mlp(nn.Module):
    """Linear -> activation -> Linear, Flax names fc1/fc2."""

    def __init__(self, in_features: int, hidden: int, out: int, activation=F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, out, dtype=dtype)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.activation(self.fc1(x)))


class LayerNorm(nn.LayerNorm):
    """Flax-convention LayerNorm: eps 1e-6, statistics in float32, output in `dtype`."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(stat_dtype(x)), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """Flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over an NCHW input in
    `dtype`, with float32 parameters and statistics.

    Eval mode normalises with the running statistics. Train mode takes the
    batch mean and the biased variance E[x^2] - E[x]^2 in float32, as Flax's
    `_compute_stats` does, normalises with them and updates the running
    statistics as ``0.9 * old + 0.1 * batch``, with the biased variance.
    torch's own train-mode update uses the unbiased n/(n-1) variance, which
    after one step differs from Flax's by n/(n-1); it is not used here, and
    `num_batches_tracked` is not advanced (Flax has no counterpart).

    Under a process group of more than one rank (data-parallel training)
    the train-mode statistics are global, as a JAX batch sharded over a
    mesh computes them: each rank's per-channel sums of x and x^2 and its
    row count are summed over the group by a differentiable all-reduce,
    and the mean and E[x^2] - E[x]^2 come from the global sums, so the
    running statistics are the same on every rank.
    """

    MOMENTUM = 0.9  # Flax's convention: the weight of the old statistics

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=BN_EPS, momentum=1.0 - self.MOMENTUM)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if not self.training:
            return super().forward(x)
        xf = x.to(stat_dtype(x))
        dims = (0, 2, 3)
        if world_size() > 1:
            mean, var = _global_moments(xf, dims)
        else:
            mean = xf.mean(dims)
            var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.compute_dtype)

    def eval_affine(self):
        """Exact float32 (scale, bias) of this BatchNorm in eval mode."""
        return bn_eval_affine(self.weight, self.bias, self.running_mean, self.running_var, self.eps)


def _global_moments(xf: torch.Tensor, dims) -> tuple:
    """(mean, biased variance) per channel over every rank's rows: one
    differentiable all-reduce of (sum x, sum x^2, count)."""
    C = xf.shape[1]
    count = torch.full((1,), xf.numel() // C, dtype=xf.dtype, device=xf.device)
    sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
    n = sums[-1]
    mean = sums[:C] / n
    return mean, torch.clamp_min(sums[C:2 * C] / n - mean * mean, 0.0)


class Dropout(nn.Module):
    """Flax `nn.Dropout`: in train mode each element is kept with probability
    1 - p and scaled by 1 / (1 - p), else zeroed; the identity in eval mode
    or at p = 0. The keep mask is drawn from `generator` when one is set
    (`set_dropout_generator`), else from torch's default generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every `Dropout` under `module` draw from `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def disable_dropout(module: nn.Module) -> None:
    """Set the rate of every `Dropout` under `module` to 0 (the identity)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def softmax_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax with float32 statistics, returned in `x`'s dtype."""
    return torch.softmax(x, dim=dim, dtype=stat_dtype(x)).to(x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation: x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections and dropout `dropout` on the
    attention probabilities."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(d_model, d_model, dtype=dtype)
        self.k_proj = Linear(d_model, d_model, dtype=dtype)
        self.v_proj = Linear(d_model, d_model, dtype=dtype)
        self.out_proj = Linear(d_model, d_model, dtype=dtype)
        self.attn_drop = Dropout(dropout)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        B, Tq, C = q_in.shape
        d_head = C // self.num_heads

        def split(x):
            return x.reshape(B, x.shape[1], self.num_heads, d_head).transpose(1, 2)

        q, k, v = split(self.q_proj(q_in)), split(self.k_proj(k_in)), split(self.v_proj(v_in))
        att = self.attn_drop(softmax_f32((q @ k.transpose(-2, -1)) / math.sqrt(d_head)))
        y = (att @ v).transpose(1, 2).reshape(B, Tq, C)
        return self.out_proj(y)


class TransformerDecoderLayer(nn.Module):
    """torch `nn.TransformerDecoderLayer` semantics: post-LN, ReLU FFN, with
    dropout `dropout` in the attentions, on both attention outputs, after the
    FFN's ReLU and on its output."""

    def __init__(self, d_model: int, num_heads: int, d_ffn: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype, dropout)
        self.norm1 = LayerNorm(d_model, dtype)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dtype, dropout)
        self.norm2 = LayerNorm(d_model, dtype)
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype)
        self.drop_sa, self.drop_ca = Dropout(dropout), Dropout(dropout)
        self.drop_ffn, self.drop_out = Dropout(dropout), Dropout(dropout)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = self.norm1(tgt + self.drop_sa(self.self_attn(tgt, tgt, tgt)))
        x = self.norm2(x + self.drop_ca(self.cross_attn(x, memory, memory)))
        h = self.linear2(self.drop_ffn(F.relu(self.linear1(x))))
        return self.norm3(x + self.drop_out(h))


class TransformerDecoder(nn.Module):
    """Stack of `TransformerDecoderLayer`s named layer0..layerN-1 (no final norm)."""

    def __init__(self, d_model: int, num_heads: int, d_ffn: int, num_layers: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerDecoderLayer(d_model, num_heads, d_ffn, dtype,
                                                                 dropout))

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
            if isinstance(owner, (nn.LayerNorm, nn.BatchNorm2d, GroupNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "weight":
                # a transposed conv's weight is (in, out, k): its fan-in is in * k
                fan_in = p[:, 0].numel() if isinstance(owner, nn.ConvTranspose1d) else p[0].numel()
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            else:  # pos_emb, keyval_embedding, query_embedding
                p.normal_(0.0, 1.0, generator=generator)
