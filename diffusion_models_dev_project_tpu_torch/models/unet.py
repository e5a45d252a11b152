"""ADM ("guided-diffusion") score UNet in PyTorch, NHWC.

Port of `models/unet.py` of the JAX package without LoRA: the same
`UNetConfig`, the same `build_arch_spec` walk, and modules named after the
flax parameter tree (`in_1_0.conv1`, `mid_1.qkv`, `time_dense_0`, ...), so a
flax checkpoint maps onto `state_dict()` mechanically (`models/convert.py`).

Conventions kept from the reference:
- sinusoidal timestep embedding, cos first, max_period 10000;
- GroupNorm(32) statistics in fp32, variance as E[x²] - E[x]² clamped at 0;
- ResBlock with scale-shift (FiLM) conditioning and up/down variants;
- AttentionBlock with the legacy head order (heads split before q, k, v:
  the channel layout is [head][q|k|v][ch]) and d^-1/4 scaling on q and k;
- a `learn_sigma` model (2 output channels) returns channel 0.

Every stride-1 3x3 conv runs through `ops.conv3x3.conv3x3` and every
attention through `ops.attention.attention`, the two hand-written CUDA
kernels on a CUDA tensor.  With `dtype="bfloat16"` the body computes in bf16
(fp32 accumulation inside the kernels and cuBLAS); the final GroupNorm and
conv run in the input's dtype, as in the reference.  Weights keep the JAX
layouts: 3x3 convs HWIO, dense and 1x1 layers as `nn.Linear` (O, I).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.conv3x3 import conv3x3

__all__ = ["UNetModel", "UNetConfig", "build_arch_spec", "timestep_embedding",
           "create_model_config", "group_norm32"]


# ----------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 256
    in_channels: int = 1
    out_channels: int = 1
    model_channels: int = 256
    num_res_blocks: int = 1
    attention_resolutions: Tuple[int, ...] = (16,)   # downsample rates
    dropout: float = 0.0
    channel_mult: Tuple[float, ...] = (1, 1, 2, 2, 4, 4)
    conv_resample: bool = True
    num_heads: int = 4
    num_head_channels: int = 64
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    dtype: str = "float32"          # compute dtype: "float32" | "bfloat16"
    # accepted for config compatibility with the JAX package and ignored
    # here: attention always runs the attention kernel, every stride-1 3x3
    # conv the conv3x3 kernel (these select TPU code paths there)
    attention_impl: str = "auto"
    small_conv_matmul: int = 0
    pallas_conv_min: int = 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def create_model_config(model_cfg) -> UNetConfig:
    """UNetConfig from a model config section, with the reference's
    derivations: channel_mult from the image size, and attention
    resolutions turned into downsample rates."""
    image_size = model_cfg.image_size
    channel_mult = getattr(model_cfg, "channel_mult", "")
    if channel_mult in ("", None):
        table = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
                 320: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}
        if image_size not in table:
            raise ValueError(f"unsupported image size: {image_size}")
        channel_mult = table[image_size]
    else:
        channel_mult = tuple(int(m) for m in str(channel_mult).split(","))
    attn_res = getattr(model_cfg, "attention_resolutions", "16")
    attention_ds = tuple(image_size // int(r) for r in str(attn_res).split(","))
    return UNetConfig(
        image_size=image_size,
        in_channels=model_cfg.in_channels,
        out_channels=model_cfg.out_channels,
        model_channels=model_cfg.num_channels,
        num_res_blocks=model_cfg.num_res_blocks,
        attention_resolutions=attention_ds,
        dropout=getattr(model_cfg, "dropout", 0.0),
        channel_mult=channel_mult,
        num_heads=getattr(model_cfg, "num_heads", 1),
        num_head_channels=getattr(model_cfg, "num_head_channels", -1),
        num_heads_upsample=getattr(model_cfg, "num_heads_upsample", -1),
        use_scale_shift_norm=getattr(model_cfg, "use_scale_shift_norm", False),
        resblock_updown=getattr(model_cfg, "resblock_updown", False),
        dtype=getattr(model_cfg, "dtype", "float32"),
        attention_impl=getattr(model_cfg, "attention_impl", "auto"),
        small_conv_matmul=int(getattr(model_cfg, "small_conv_matmul", 0)),
        pallas_conv_min=int(getattr(model_cfg, "pallas_conv_min", 0)),
    )


# ----------------------------------------------------------------- specs
@dataclasses.dataclass(frozen=True)
class ResSpec:
    in_ch: int
    out_ch: int
    mode: Optional[str] = None          # None | "up" | "down"


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    ch: int
    num_heads: int


@dataclasses.dataclass(frozen=True)
class SampleSpec:                        # standalone Up/Downsample layer
    ch: int
    out_ch: int
    mode: str                            # "up" | "down"
    use_conv: bool = True


@dataclasses.dataclass(frozen=True)
class ConvSpec:                          # plain 3x3 conv (stem)
    in_ch: int
    out_ch: int


def _heads_for(ch: int, cfg: UNetConfig, upsample: bool) -> int:
    if cfg.num_head_channels != -1:
        if ch % cfg.num_head_channels:
            raise ValueError(f"{ch} channels do not split into heads of {cfg.num_head_channels}")
        return ch // cfg.num_head_channels
    if upsample and cfg.num_heads_upsample != -1:
        return cfg.num_heads_upsample
    return cfg.num_heads


def build_arch_spec(cfg: UNetConfig):
    """The ADM block structure: (input_blocks, middle_block, output_blocks,
    stem channels), each *_blocks a list of lists of specs."""
    mc = cfg.model_channels
    ch = input_ch = int(cfg.channel_mult[0] * mc)
    input_blocks: List[List] = [[ConvSpec(cfg.in_channels, ch)]]
    input_block_chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers: List = [ResSpec(ch, int(mult * mc))]
            ch = int(mult * mc)
            if ds in cfg.attention_resolutions:
                layers.append(AttnSpec(ch, _heads_for(ch, cfg, False)))
            input_blocks.append(layers)
            input_block_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                input_blocks.append([ResSpec(ch, ch, mode="down")])
            else:
                input_blocks.append([SampleSpec(ch, ch, "down", cfg.conv_resample)])
            input_block_chans.append(ch)
            ds *= 2

    middle_block: List = [
        ResSpec(ch, ch),
        AttnSpec(ch, _heads_for(ch, cfg, False)),
        ResSpec(ch, ch),
    ]

    output_blocks: List[List] = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_block_chans.pop()
            layers = [ResSpec(ch + ich, int(mc * mult))]
            ch = int(mc * mult)
            if ds in cfg.attention_resolutions:
                layers.append(AttnSpec(ch, _heads_for(ch, cfg, True)))
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    layers.append(ResSpec(ch, ch, mode="up"))
                else:
                    layers.append(SampleSpec(ch, ch, "up", cfg.conv_resample))
                ds //= 2
            output_blocks.append(layers)

    return input_blocks, middle_block, output_blocks, input_ch


# ----------------------------------------------------------------- pieces
def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_norm32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC with fp32 statistics: per-channel spatial means of
    x and x² combined over each group, variance E[x²] - E[x]² clamped at 0,
    then one multiply-add pass; the result in x's dtype."""
    b, _, _, c = x.shape
    g, cg = num_groups, c // num_groups
    xf = x.float()
    m_c = xf.mean(dim=(1, 2))                           # (B, C)
    m2_c = xf.square().mean(dim=(1, 2))
    m_g = m_c.reshape(b, g, cg).mean(dim=-1)            # (B, G)
    m2_g = m2_c.reshape(b, g, cg).mean(dim=-1)
    var_g = torch.clamp(m2_g - m_g.square(), min=0.0)
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(cg, dim=-1)
    mean_c = m_g.repeat_interleave(cg, dim=-1)
    a = inv_c * weight.float()[None]
    bb = bias.float()[None] - mean_c * a
    return (xf * a[:, None, None, :] + bb[:, None, None, :]).to(x.dtype)


class GroupNorm32(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm32(x, self.weight, self.bias, self.num_groups)


class Conv3x3(nn.Module):
    """Stride-1 zero-pad-1 3x3 conv; weight HWIO (3, 3, Cin, Cout).  Input
    and weight are cast to `dtype` (no copy when they already have it)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(9 * cin))

    def forward(self, x, use_kernel: bool = True):
        return conv3x3(x.to(self.dtype), self.weight.to(self.dtype), self.bias,
                       use_kernel=use_kernel)


class Dense(nn.Linear):
    """`nn.Linear` computing in `dtype` (flax `nn.Dense(dtype=...)`); also the
    1x1 conv of a ResBlock skip, which is a dense layer over NHWC channels."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__(cin, cout)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def _upsample_nearest(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _avg_pool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class ResBlock(nn.Module):
    def __init__(self, spec: ResSpec, emb_ch: int, use_scale_shift_norm: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.spec = spec
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norm1 = GroupNorm32(spec.in_ch)
        self.conv1 = Conv3x3(spec.in_ch, spec.out_ch, dtype)
        self.emb = Dense(emb_ch, 2 * spec.out_ch if use_scale_shift_norm else spec.out_ch, dtype)
        self.norm2 = GroupNorm32(spec.out_ch)
        self.conv2 = Conv3x3(spec.out_ch, spec.out_ch, dtype)
        self.skip = Dense(spec.in_ch, spec.out_ch, dtype) if spec.out_ch != spec.in_ch else None

    def forward(self, x, emb, use_kernel: bool = True):
        h = F.silu(self.norm1(x))
        if self.spec.mode == "up":
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif self.spec.mode == "down":
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = self.conv1(h, use_kernel)
        emb_out = self.emb(F.silu(emb))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.norm2(h) * (1 + scale) + shift
        else:
            h = self.norm2(h + emb_out)
        h = self.conv2(F.silu(h), use_kernel)
        skip = x if self.skip is None else self.skip(x)
        return skip + h


class AttentionBlock(nn.Module):
    def __init__(self, spec: AttnSpec, dtype: torch.dtype):
        super().__init__()
        self.spec = spec
        self.norm = GroupNorm32(spec.ch)
        self.qkv = Dense(spec.ch, 3 * spec.ch, dtype)
        self.proj = Dense(spec.ch, spec.ch, dtype)

    def forward(self, x, use_kernel: bool = True):
        b, hgt, wid, c = x.shape
        heads = self.spec.num_heads
        ch = c // heads
        hw = hgt * wid
        qkv = self.qkv(self.norm(x).reshape(b, hw, c))
        # legacy order: heads split BEFORE q/k/v -> [head][q|k|v][ch]
        qkv = qkv.reshape(b, hw, heads, 3 * ch).permute(0, 2, 1, 3)    # (b, heads, hw, 3ch)
        q, k, v = (a.reshape(b * heads, hw, ch).contiguous()
                   for a in qkv.split(ch, dim=-1))
        att = attention(q, k, v, use_kernel=use_kernel)
        att = att.reshape(b, heads, hw, ch).permute(0, 2, 1, 3).reshape(b, hw, c)
        return x + self.proj(att).reshape(b, hgt, wid, c)


class Sample(nn.Module):
    """Standalone Up/Downsample layer (used when `resblock_updown` is off)."""

    def __init__(self, spec: SampleSpec, dtype: torch.dtype):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        if spec.use_conv:
            self.conv = Conv3x3(spec.ch, spec.out_ch, dtype)

    def forward(self, x, use_kernel: bool = True):
        s = self.spec
        if s.mode == "up":
            x = _upsample_nearest(x)
            return self.conv(x, use_kernel) if s.use_conv else x
        if s.use_conv:
            # stride-2 conv with symmetric padding 1 (no kernel of its own)
            w = self.conv.weight.to(self.dtype).permute(3, 2, 0, 1)
            y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                         self.conv.bias.to(self.dtype), stride=2, padding=1)
            return y.permute(0, 2, 3, 1)
        return _avg_pool2(x)


# ----------------------------------------------------------------- model
class UNetModel(nn.Module):
    """The full UNet; input NHWC (B, H, W, C), timesteps (B,)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.torch_dtype
        mc = cfg.model_channels
        self.time_dense_0 = Dense(mc, 4 * mc, dtype)
        self.time_dense_1 = Dense(4 * mc, 4 * mc, dtype)
        input_blocks, middle_block, output_blocks, _ = build_arch_spec(cfg)
        # (group, [(module name, spec), ...]) per block, in call order
        self._blocks = []
        groups = ([("in", f"in_{i}", blk) for i, blk in enumerate(input_blocks)]
                  + [("mid", "mid", middle_block)]
                  + [("out", f"out_{i}", blk) for i, blk in enumerate(output_blocks)])
        for group, prefix, block in groups:
            layers = []
            for j, spec in enumerate(block):
                self.add_module(f"{prefix}_{j}", self._make(spec, dtype))
                layers.append((f"{prefix}_{j}", spec))
            self._blocks.append((group, layers))
        last_ch = int(cfg.channel_mult[0] * mc)
        self.final_norm = GroupNorm32(last_ch)
        self.final_conv = Conv3x3(last_ch, cfg.out_channels, torch.float32)

    def _make(self, spec, dtype):
        cfg = self.cfg
        if isinstance(spec, ResSpec):
            return ResBlock(spec, 4 * cfg.model_channels, cfg.use_scale_shift_norm, dtype)
        if isinstance(spec, AttnSpec):
            return AttentionBlock(spec, dtype)
        if isinstance(spec, SampleSpec):
            return Sample(spec, dtype)
        if isinstance(spec, ConvSpec):
            return Conv3x3(spec.in_ch, spec.out_ch, dtype)
        raise TypeError(spec)

    def _call(self, name, spec, h, emb, use_kernel):
        layer = getattr(self, name)
        if isinstance(spec, ResSpec):
            return layer(h, emb, use_kernel)
        return layer(h, use_kernel)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
        """`use_kernel=False` runs every conv and attention through its plain
        PyTorch version on a CUDA tensor too (for comparisons only)."""
        cfg = self.cfg
        in_dtype = x.dtype
        emb = self.time_dense_0(timestep_embedding(timesteps, cfg.model_channels))
        emb = self.time_dense_1(F.silu(emb))

        h = x.to(cfg.torch_dtype)
        hs = []
        for group, layers in self._blocks:
            if group == "out":
                h = torch.cat([h, hs.pop()], dim=-1)
            for name, spec in layers:
                h = self._call(name, spec, h, emb, use_kernel)
            if group == "in":
                hs.append(h)

        h = F.silu(self.final_norm(h.to(in_dtype)))
        h = self.final_conv(h, use_kernel)
        if cfg.out_channels == 2:            # learn_sigma: the mean channel
            return h[..., :1]
        return h
