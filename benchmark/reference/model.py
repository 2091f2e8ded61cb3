"""Plain PyTorch reference of DiffusionDrive (Transfuser backbone, truncated
diffusion head), written from the published description and the
architecture's equations, independent of the program under test.

The model is a set of functions over a dict of weights (name -> tensor) in
the layout of the published checkpoint's `state_dict` (`backbone.*`,
`tf_decoder.*`, `trajectory_head.*`, ...), so one set of weights made by the
benchmark feeds both sides. Everything computes in float32; `Precision`
rounds the operands of every product for the lower-precision control.

Departures from the published code, each as the program under test runs it:
LayerNorm eps 1e-6; BatchNorm in train mode normalises with the biased batch
variance; the GPT fusion has no positional dropout beyond `embd_pdrop`; the
diffusion decoder's FFN replaces (does not add to) its input.

`Draws` feeds every random draw (dropout masks, diffusion timesteps and
noise) from one generator in the order the forward makes them.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.precision import Precision

LN_EPS = 1e-6
BN_EPS = 1e-5
NORM_OFFSET = (1.2, 20.0, 2.0)
NORM_SCALE = (56.9, 46.0, 3.9)

# name: (block kind, blocks per stage, widths, stage output channels)
RESNETS = {
    "resnet18": ("basic", (2, 2, 2, 2), (64, 128, 256, 512), (64, 128, 256, 512)),
    "resnet34": ("basic", (3, 4, 6, 3), (64, 128, 256, 512), (64, 128, 256, 512)),
    "resnet50": ("bottleneck", (3, 4, 6, 3), (64, 128, 256, 512), (256, 512, 1024, 2048)),
}


@dataclass
class Draws:
    """The forward's random draws. `generator` feeds the dropout masks (and,
    in training, the head's timesteps and noise unless given); with
    `generator` None dropout is the identity (eval)."""
    generator: Optional[torch.Generator] = None
    timesteps: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if self.generator is None or p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class Net:
    """The reference forward over weights `W` for config `cfg` (a dict of the
    configuration's keys, as run), in precision `prec`, train or eval."""

    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict, prec: Precision, train: bool,
                 draws: Optional[Draws] = None, recompute: bool = True):
        self.W, self.cfg, self.prec, self.train = W, cfg, prec, train
        self.draws = draws or Draws()
        self.recompute = recompute and train

    # -- primitives ------------------------------------------------------------------------------
    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.prec
        y = F.linear(p.operand(x), p.operand(self.W[name + ".weight"]), self.W.get(name + ".bias"))
        return p.output(y)

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
        p = self.prec
        y = F.conv2d(p.operand(x), p.operand(self.W[name + ".weight"]), self.W.get(name + ".bias"),
                     stride=stride, padding=padding)
        return p.output(y)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.prec.output(self.prec.operand(a) @ self.prec.operand(b))

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.W[name + ".weight"], self.W[name + ".bias"], LN_EPS)

    def batch_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        W = self.W
        if self.train:   # batch statistics, biased variance
            mean = x.mean((0, 2, 3))
            var = (x * x).mean((0, 2, 3)) - mean * mean
        else:
            mean, var = W[name + ".running_mean"], W[name + ".running_var"]
        scale = W[name + ".weight"] / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + W[name + ".bias"][:, None, None]

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        return self.draws.dropout(x, p) if self.train else x

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pdrop: float) -> torch.Tensor:
        """Scaled dot-product attention over (B, H, T, D), dropout on the probabilities."""
        att = torch.softmax(self.matmul(q, k.transpose(-2, -1)) / math.sqrt(q.shape[-1]), dim=-1)
        return self.matmul(self.dropout(att, pdrop), v)

    def mha(self, name: str, q_in, k_in, v_in, heads: int, pdrop: float = 0.0) -> torch.Tensor:
        B, Tq, C = q_in.shape

        def split(x):
            return x.reshape(B, x.shape[1], heads, C // heads).transpose(1, 2)

        y = self.attention(split(self.linear(name + ".q_proj", q_in)), split(self.linear(name + ".k_proj", k_in)),
                           split(self.linear(name + ".v_proj", v_in)), pdrop)
        return self.linear(name + ".out_proj", y.transpose(1, 2).reshape(B, Tq, C))

    def linear_relu_ln(self, name: str, x: torch.Tensor, in_loops: int, out_loops: int) -> torch.Tensor:
        for o in range(out_loops):
            for i in range(in_loops):
                x = F.relu(self.linear(f"{name}.dense_{o}_{i}", x))
            x = self.layer_norm(f"{name}.ln_{o}", x)
        return x

    # -- ResNet ----------------------------------------------------------------------------------
    def stem(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.batch_norm(name + ".bn1", self.conv(name + ".conv1", x, 2, 3)))
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def block(self, name: str, kind: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        if kind == "basic":
            y = F.relu(self.batch_norm(name + ".bn1", self.conv(name + ".conv1", x, stride, 1)))
            y = self.batch_norm(name + ".bn2", self.conv(name + ".conv2", y, 1, 1))
        else:
            y = F.relu(self.batch_norm(name + ".bn1", self.conv(name + ".conv1", x)))
            y = F.relu(self.batch_norm(name + ".bn2", self.conv(name + ".conv2", y, stride, 1)))
            y = self.batch_norm(name + ".bn3", self.conv(name + ".conv3", y))
        if name + ".downsample_conv.weight" in self.W:
            x = self.batch_norm(name + ".downsample_bn", self.conv(name + ".downsample_conv", x, stride))
        return F.relu(y + x)

    def stage(self, name: str, kind: str, blocks: int, x: torch.Tensor, stride: int) -> torch.Tensor:
        """A ResNet stage; with `recompute` each block's activations are
        recomputed in the backward (they hold no random draw), so that the
        float32 reference fits beside the program at the timed batch."""
        for i in range(blocks):
            fn = functools.partial(self.block, f"{name}.block{i}", kind, stride=stride if i == 0 else 1)
            x = checkpoint(fn, x, use_reentrant=False) if self.recompute and torch.is_grad_enabled() else fn(x)
        return x

    # -- GPT fusion ------------------------------------------------------------------------------
    def gpt(self, name: str, img: torch.Tensor, lid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, C, ih, iw = img.shape
        _, _, lh, lw = lid.shape
        x = torch.cat([img.flatten(2).transpose(1, 2), lid.flatten(2).transpose(1, 2)], dim=1)
        x = self.dropout(x + self.W[name + ".pos_emb"], cfg["embd_pdrop"])
        heads, T = cfg["n_head"], x.shape[1]
        for i in range(cfg["n_layer"]):
            blk = f"{name}.block{i}"
            h = self.layer_norm(blk + ".ln1", x)

            def split(t):
                return t.reshape(B, T, heads, C // heads).transpose(1, 2)

            y = self.attention(split(self.linear(blk + ".attn.query", h)), split(self.linear(blk + ".attn.key", h)),
                               split(self.linear(blk + ".attn.value", h)), cfg["attn_pdrop"])
            y = self.linear(blk + ".attn.proj", y.transpose(1, 2).reshape(B, T, C))
            x = x + self.dropout(y, cfg["resid_pdrop"])
            h = F.relu(self.linear(blk + ".mlp_fc1", self.layer_norm(blk + ".ln2", x)))
            x = x + self.dropout(self.linear(blk + ".mlp_fc2", h), cfg["resid_pdrop"])
        x = self.layer_norm(name + ".ln_f", x)
        n_img = ih * iw
        return (x[:, :n_img].transpose(1, 2).reshape(B, C, ih, iw),
                x[:, n_img:].transpose(1, 2).reshape(B, C, lh, lw))

    def backbone(self, camera: torch.Tensor, lidar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        ikind, isizes, _, _ = RESNETS[cfg["image_architecture"]]
        lkind, lsizes, _, _ = RESNETS[cfg["lidar_architecture"]]
        img = self.stem("backbone.image_encoder_stem", camera)
        lid = self.stem("backbone.lidar_encoder_stem", lidar)
        for i in range(4):
            s = 1 if i == 0 else 2
            img = self.stage(f"backbone.image_encoder_layer{i + 1}", ikind, isizes[i], img, s)
            lid = self.stage(f"backbone.lidar_encoder_layer{i + 1}", lkind, lsizes[i], lid, s)
            it = F.adaptive_avg_pool2d(img, (cfg["img_vert_anchors"], cfg["img_horz_anchors"]))
            lt = F.adaptive_avg_pool2d(lid, (cfg["lidar_vert_anchors"], cfg["lidar_horz_anchors"]))
            lt = self.conv(f"backbone.lidar_to_img{i}", lt)
            io, lo = self.gpt(f"backbone.fusion{i}", it, lt)
            lo = self.conv(f"backbone.img_to_lidar{i}", lo)
            img = img + upsample(io, img.shape[2:])
            lid = lid + upsample(lo, lid.shape[2:])
        p5 = F.relu(self.conv("backbone.c5_conv", lid))
        p4 = F.relu(self.conv("backbone.up_conv5", upsample(p5, (p5.shape[2] * cfg["bev_upsample_factor"],
                                                                   p5.shape[3] * cfg["bev_upsample_factor"])), 1, 1))
        size = (cfg["lidar_resolution_height"] // cfg["bev_down_sample_factor"],
                cfg["lidar_resolution_width"] // cfg["bev_down_sample_factor"])
        p3 = F.relu(self.conv("backbone.up_conv4", upsample(p4, size), 1, 1))
        return p3, lid

    # -- diffusion head --------------------------------------------------------------------------
    def embed_anchor(self, points: torch.Tensor) -> torch.Tensor:
        B, M, P, _ = points.shape
        pos = sine_embed(points, 64).reshape(B, M, P * 64)
        h = self.linear_relu_ln("trajectory_head.anchor_encoder_ln", pos, 1, 1)
        return self.linear("trajectory_head.anchor_encoder_out", h)

    def embed_time(self, t: torch.Tensor) -> torch.Tensor:
        h = time_embed(t, self.cfg["tf_d_model"])
        h = mish(self.linear("trajectory_head.time_fc1", h))
        return self.linear("trajectory_head.time_fc2", h)[:, None, :]

    def decoder_layer(self, name: str, feat, points, bev, agents, ego, t_emb):
        cfg, heads = self.cfg, self.cfg["tf_num_head"]
        # BEV sampling at the trajectory points with learned point weights
        grid = torch.stack([points[..., 1] / cfg["lidar_max_y"], points[..., 0] / cfg["lidar_max_x"]], dim=-1)
        weights = torch.softmax(self.linear(name + ".cross_bev.attention_weights", feat), dim=-1)
        value = F.relu(self.conv(name + ".cross_bev.value_conv", bev, 1, 1))
        sampled = F.grid_sample(value, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False).permute(0, 2, 3, 1)
        out = torch.einsum("bmp,bmpc->bmc", weights, sampled)
        x = self.dropout(self.linear(name + ".cross_bev.output_proj", out), 0.1) + feat
        x = self.layer_norm(name + ".norm1", x + self.dropout(
            self.mha(name + ".cross_agent", x, agents, agents, heads, cfg["tf_dropout"]), 0.1))
        x = self.layer_norm(name + ".norm2", x + self.dropout(
            self.mha(name + ".cross_ego", x, ego, ego, heads, cfg["tf_dropout"]), 0.1))
        x = self.layer_norm(name + ".norm3", self.linear(name + ".ffn_fc2", F.relu(self.linear(name + ".ffn_fc1", x))))
        scale, shift = self.linear(name + ".time_modulation.scale_shift", mish(t_emb)).chunk(2, dim=-1)
        x = x * (1.0 + scale) + shift
        B, M, _ = x.shape
        td = name + ".task_decoder"
        cls = self.linear(td + ".cls_out", self.linear_relu_ln(td + ".cls_ln", x, 1, 2))[..., 0]
        h = F.relu(self.linear(td + ".reg_fc2", F.relu(self.linear(td + ".reg_fc1", x))))
        reg = self.linear(td + ".reg_out", h).reshape(B, M, -1, 3)
        return torch.cat([reg[..., :2] + points, torch.tanh(reg[..., 2:3]) * math.pi], dim=-1), cls

    def cascade(self, feat, points, bev, agents, ego, t_emb) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        regs, clss = [], []
        for i in range(self.cfg["diff_decoder_layers"]):
            reg, cls = self.decoder_layer(f"trajectory_head.layer{i}", feat, points, bev, agents, ego, t_emb)
            regs.append(reg)
            clss.append(cls)
            points = reg[..., :2].detach()
        return regs, clss

    def head_train(self, ego, agents, bev) -> Dict[str, torch.Tensor]:
        B = ego.shape[0]
        anchors = self.W["trajectory_head.plan_anchor"][None].expand(B, -1, -1, -1)
        d = self.draws
        t = d.timesteps
        if t is None:
            t = torch.randint(0, self.cfg["diffusion_train_max_t"], (B,), generator=d.generator, device=ego.device)
        noise = d.noise
        if noise is None:
            noise = torch.randn(anchors.shape, generator=d.generator, device=ego.device)
        noisy = add_noise(norm_odo(anchors), noise, t)
        points = denorm_odo(noisy.clamp(-1.0, 1.0))
        regs, clss = self.cascade(self.embed_anchor(points), points, bev, agents, ego, self.embed_time(t))
        return {"poses_reg_layers": torch.stack(regs), "poses_cls_layers": torch.stack(clss), "plan_anchor": anchors}

    def head_test(self, ego, agents, bev) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B = ego.shape[0]
        img = norm_odo(self.W["trajectory_head.plan_anchor"][None].expand(B, -1, -1, -1))
        trunc = torch.full((B,), cfg["diffusion_test_trunc_t"], dtype=torch.long, device=ego.device)
        img = add_noise(img, self.draws.noise, trunc)
        span, steps = cfg["diffusion_test_span"], cfg["diffusion_test_steps"]
        reg = cls = None
        for k in np.round(np.arange(steps) * (span / steps))[::-1].astype(np.int64):
            points = denorm_odo(img.clamp(-1.0, 1.0))
            t = torch.full((B,), int(k), dtype=torch.long, device=ego.device)
            regs, clss = self.cascade(self.embed_anchor(points), points, bev, agents, ego, self.embed_time(t))
            reg, cls = regs[-1], clss[-1]
            img = ddim_step(norm_odo(reg[..., :2]), int(k), img)
        best = reg[torch.arange(B, device=reg.device), cls.argmax(-1)]
        return {"trajectory": best, "poses_reg": reg, "poses_cls": cls}

    # -- the whole model -------------------------------------------------------------------------
    def __call__(self, camera: torch.Tensor, lidar: torch.Tensor, status: torch.Tensor) -> Dict[str, torch.Tensor]:
        """camera (B, H, W, 3) float in [0, 1], lidar (B, h, w, C), status (B, 8)."""
        cfg = self.cfg
        d = cfg["tf_d_model"]
        B = status.shape[0]
        bev_up, bev = self.backbone(camera.permute(0, 3, 1, 2), lidar.permute(0, 3, 1, 2))
        bh, bw = bev.shape[2:]
        tokens = self.conv("bev_downscale", bev).flatten(2).transpose(1, 2)
        keyval = torch.cat([tokens, self.linear("status_encoding", status)[:, None]], dim=1)
        keyval = keyval + self.W["keyval_embedding"][None]
        kv_bev = upsample(keyval[:, :-1].transpose(1, 2).reshape(B, d, bh, bw), bev_up.shape[2:])
        cross = self.linear_relu_ln("bev_proj", torch.cat([kv_bev, bev_up], dim=1).permute(0, 2, 3, 1), 1, 1)
        cross = cross.permute(0, 3, 1, 2)

        x = self.W["query_embedding"][None].expand(B, -1, -1)
        heads, pdrop = cfg["tf_num_head"], cfg["tf_dropout"]
        for i in range(cfg["tf_num_layers"]):
            n = f"tf_decoder.layer{i}"
            x = self.layer_norm(n + ".norm1", x + self.dropout(self.mha(n + ".self_attn", x, x, x, heads, pdrop), pdrop))
            x = self.layer_norm(n + ".norm2", x + self.dropout(
                self.mha(n + ".cross_attn", x, keyval, keyval, heads, pdrop), pdrop))
            h = self.linear(n + ".linear2", self.dropout(F.relu(self.linear(n + ".linear1", x)), pdrop))
            x = self.layer_norm(n + ".norm3", x + self.dropout(h, pdrop))
        ego, agents = x[:, :1], x[:, 1:]

        sem = self.conv("bev_semantic_conv2", F.relu(self.conv("bev_semantic_conv1", bev_up, 1, 1)))
        out = {"bev_semantic_map": upsample(sem, (cfg["bev_pixel_height"], cfg["bev_pixel_width"])).permute(0, 2, 3, 1)}
        out.update(self.head_train(ego, agents, cross) if self.train else self.head_test(ego, agents, cross))
        states = self.linear("agent_head.states_fc2", F.relu(self.linear("agent_head.states_fc1", agents)))
        out["agent_states"] = torch.cat([torch.tanh(states[..., :2]) * 32.0, torch.tanh(states[..., 2:3]) * math.pi,
                                         states[..., 3:]], dim=-1)
        out["agent_labels"] = self.linear("agent_head.label_fc", agents)[..., 0]
        return out


# -- free functions ------------------------------------------------------------------------------
def upsample(x: torch.Tensor, size) -> torch.Tensor:
    size = (int(size[0]), int(size[1]))
    if size == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def sine_embed(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., 2) points -> (..., dim): [y | x], each interleaved sin/cos (DAB-DETR)."""
    half = dim // 2
    dim_t = torch.tensor((10000.0 ** (2.0 * (np.arange(half) // 2) / half)).astype(np.float32), device=pos.device)

    def one(c):
        p = (c * (2.0 * math.pi))[..., None] / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1).reshape(*p.shape[:-1], half)

    return torch.cat([one(pos[..., 1]), one(pos[..., 0])], dim=-1)


def time_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.tensor(np.exp(np.arange(half) * -(math.log(10000.0) / (half - 1))).astype(np.float32),
                         device=t.device)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([args.sin(), args.cos()], dim=-1)


def _norm_box(x: torch.Tensor):
    n = x.shape[-1]
    return (torch.tensor(NORM_OFFSET[:n], dtype=x.dtype, device=x.device),
            torch.tensor(NORM_SCALE[:n], dtype=x.dtype, device=x.device))


def norm_odo(x: torch.Tensor) -> torch.Tensor:
    off, scale = _norm_box(x)
    return 2.0 * (x + off) / scale - 1.0


def denorm_odo(x: torch.Tensor) -> torch.Tensor:
    off, scale = _norm_box(x)
    return (x + 1.0) / 2.0 * scale - off


def alphas_cumprod() -> np.ndarray:
    """DDIM's scaled-linear schedule over 1000 steps, in float32."""
    betas = np.linspace(1e-4 ** 0.5, 0.02 ** 0.5, 1000, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def add_noise(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    a = torch.from_numpy(alphas_cumprod()).to(x0.device)[t.to(x0.device)]
    a = a.reshape(a.shape + (1,) * (x0.dim() - 1))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise.to(x0.dtype)


def ddim_step(pred_x0: torch.Tensor, t: int, sample: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM update (sample prediction, clipped) from step t to t - 1."""
    ac = alphas_cumprod()
    a_t = ac[t]
    a_prev = ac[t - 1] if t >= 1 else np.float32(1.0)
    one = np.float32(1.0)
    x0 = pred_x0.clamp(-1.0, 1.0)
    eps = (sample - float(np.sqrt(a_t)) * x0) / float(np.sqrt(one - a_t))
    return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(one - a_prev)) * eps
