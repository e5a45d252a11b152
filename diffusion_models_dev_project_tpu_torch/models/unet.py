"""ADM ("guided-diffusion") score UNet in PyTorch, NHWC.

Port of `models/unet.py` of the JAX package: the same `UNetConfig`, the
same `build_arch_spec` walk, and modules named after the flax parameter tree
(`in_1_0.conv1`, `mid_1.qkv`, `time_dense_0`, ...), so a flax checkpoint
maps onto `state_dict()` mechanically (`models/convert.py`).

Conventions kept from the reference:
- sinusoidal timestep embedding, cos first, max_period 10000;
- GroupNorm(32) statistics in fp32, variance as E[x²] - E[x]² clamped at 0;
- ResBlock with scale-shift (FiLM) conditioning and up/down variants;
- AttentionBlock with the legacy head order (heads split before q, k, v:
  the channel layout is [head][q|k|v][ch]) and d^-1/4 scaling on q and k;
- a `learn_sigma` model (2 output channels) returns channel 0.

Every stride-1 3x3 conv of the base model runs through `ops.conv3x3.conv3x3`
and every attention through `ops.attention.attention`, the two hand-written
CUDA kernels on a CUDA tensor (the LoRA branches below are `F.conv2d` and
`F.linear`, as JAX computes them outside its Pallas kernels).  With `dtype="bfloat16"` the body computes in bf16
(fp32 accumulation inside the kernels and cuBLAS); the final GroupNorm and
conv run in the input's dtype, as in the reference.  Weights keep the JAX
layouts: 3x3 convs HWIO, dense and 1x1 layers as `nn.Linear` (O, I).

Initialisation follows the JAX package's rule (the values differ: weights
cross over through `models/convert.py`): every ResBlock's `conv2`, the
attention `proj` and the `final_conv` start at zero, kernel and bias, so a
fresh model outputs exactly zero; every other conv and dense kernel draws
flax's `lecun_normal` (a normal truncated at two standard deviations,
scaled to variance 1/fan_in), every bias starts at zero.

Steerable adaptation (`lora_rank` > 0): every conv and dense layer of the
ResBlocks and AttentionBlocks of the groups named in `lora_include_blocks`
gains a low-rank branch (`LoRAConv`, `LoRADense`; module `<layer>_lora`, as
the JAX `lora` collection names it), scaled by the forward's `lora_scale`.
The branches compute in fp32, as JAX casts x to the LoRA weights' dtype; the
port adds a branch to its base layer's output in the compute dtype, so that
a bf16 model keeps its bf16 kernels (JAX promotes the sum to fp32 there).
At `lora_scale` 0 the branches are skipped: their output would be 0.

Images with leaves of their own: under `torch.func.functional_call` the
adapted sampler's `sample_batched` swaps each trainable leaf for a stack
with a leading image axis, one row per image of the batch (JAX vmaps the
single-image program instead).  Each layer then computes image n with row n:
a conv3x3 bias (N, Cout) goes to the kernel's epilogue, a dense bias
(N, Cout) into a batched GEMM (`baddbmm`), GroupNorm takes (N, C)
weight and bias, and a LoRA branch with `down` (N, 3, 3, Cin, r) runs as one
grouped `F.conv2d` (a group per image, as JAX's vmap folds it), its 1x1
and dense projections as batched `einsum`s.  Shared leaves compute as
before.
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

__all__ = ["LoRAConv", "LoRADense", "UNetModel", "UNetConfig", "build_arch_spec",
           "count_params", "timestep_embedding", "create_model_config", "group_norm32"]


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
    # steerable adaptation: LoRA rank (0: none) and the block groups it covers
    lora_rank: int = 0
    lora_include_blocks: Tuple[str, ...] = (
        "input_blocks", "middle_block", "output_blocks", "out")

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
    then one multiply-add pass; the result in x's dtype.  `weight` and
    `bias` are (C,), or (B, C) for a row per image."""
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
    a = inv_c * _rows(weight)
    bb = _rows(bias) - mean_c * a
    return (xf * a[:, None, None, :] + bb[:, None, None, :]).to(x.dtype)


def _rows(p: torch.Tensor) -> torch.Tensor:
    """An fp32 (C,) leaf as one row (1, C), or a stacked (B, C) one as is."""
    p = p.float()
    return p if p.ndim == 2 else p[None]


class GroupNorm32(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm32(x, self.weight, self.bias, self.num_groups)


# flax's truncated_normal draws from a standard normal cut at +-2, whose
# standard deviation this is; `variance_scaling` divides by it
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's `lecun_normal` in place: a normal truncated at two standard
    deviations, scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def _init_kernel(weight: torch.Tensor, fan_in: int, zero_init: bool) -> None:
    if zero_init:
        nn.init.zeros_(weight)
    else:
        lecun_normal_(weight, fan_in)


class Conv3x3(nn.Module):
    """Stride-1 zero-pad-1 3x3 conv; weight HWIO (3, 3, Cin, Cout).  Input
    and weight are cast to `dtype` (no copy when they already have it).
    `zero_init` starts kernel and bias at 0, else the kernel is
    `lecun_normal` (fan_in 9 Cin)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype, zero_init: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        _init_kernel(self.weight, 9 * cin, zero_init)

    def forward(self, x, use_kernel: bool = True):
        return conv3x3(x.to(self.dtype), self.weight.to(self.dtype), self.bias,
                       use_kernel=use_kernel)


class Dense(nn.Linear):
    """`nn.Linear` computing in `dtype` (flax `nn.Dense(dtype=...)`); also the
    1x1 conv of a ResBlock skip, which is a dense layer over NHWC channels.
    Initialised as flax's: the kernel `lecun_normal` (fan_in Cin) or, with
    `zero_init`, 0; the bias 0."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype, zero_init: bool = False):
        super().__init__(cin, cout)
        self.dtype = dtype
        _init_kernel(self.weight, cin, zero_init)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x, weight, bias = x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        if bias.ndim == 1:
            return F.linear(x, weight, bias)
        # a bias per image (N, Cout), row n added to image n's outputs inside
        # one batched GEMM (before its one rounding, as F.linear adds a bias)
        n, cout = bias.shape
        y = torch.baddbmm(bias[:, None, :], x.reshape(n, -1, x.shape[-1]),
                          weight.t().expand(n, -1, -1))
        return y.reshape(*x.shape[:-1], cout)


class LoRAConv(nn.Module):
    """Low-rank conv branch (JAX `LoRAConv`): a rank-r down-projection with
    the base conv's geometry, 3x3 zero-pad 1 (`down` HWIO (3, 3, Cin, r)) or
    1x1 (`down` (r, Cin)), then a 1x1 up-projection (`up` (Cout, r)), times
    `scale`, in fp32 whatever x's dtype.  Both start at 0 here; the
    adaptation's `init_lora` draws `down` ~ N(0, 1/r²) and keeps `up` at 0.
    Stacked leaves ((N, 3, 3, Cin, r) or (N, r, Cin), and (N, Cout, r)) give
    image n of x its own branch."""

    def __init__(self, cin: int, cout: int, rank: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.down = nn.Parameter(torch.zeros((3, 3, cin, rank) if kernel == 3 else (rank, cin)))
        self.up = nn.Parameter(torch.zeros(cout, rank))

    def forward(self, x, scale: float):
        x, down, up = x.float(), self.down.float(), self.up.float()
        if up.ndim == 3:
            return _scaled(self._per_image(x, down, up), scale)
        if self.kernel == 3:
            h = F.conv2d(x.permute(0, 3, 1, 2), down.permute(3, 2, 0, 1),
                         padding=1).permute(0, 2, 3, 1)
        else:
            h = F.linear(x, down)
        return _scaled(F.linear(h, up), scale)

    def _per_image(self, x, down, up):
        n, hgt, wid, cin = x.shape
        if self.kernel == 3:
            # the N images as one of N·Cin channels, one group of r outputs each
            r = down.shape[-1]
            h = F.conv2d(x.permute(0, 3, 1, 2).reshape(1, n * cin, hgt, wid),
                         down.permute(0, 4, 3, 1, 2).reshape(n * r, cin, 3, 3), padding=1,
                         groups=n)
            h = h.reshape(n, r, hgt, wid).permute(0, 2, 3, 1)
        else:
            h = torch.einsum("nhwc,nrc->nhwr", x, down)
        return torch.einsum("nhwr,ncr->nhwc", h, up)


class LoRADense(nn.Module):
    """Low-rank dense branch (JAX `LoRADense`): x @ downᵀ @ upᵀ times
    `scale`, in fp32; `down` (r, Cin), `up` (Cout, r), or stacked per image
    ((N, r, Cin), (N, Cout, r)) for x of N images."""

    def __init__(self, cin: int, cout: int, rank: int):
        super().__init__()
        self.down = nn.Parameter(torch.zeros(rank, cin))
        self.up = nn.Parameter(torch.zeros(cout, rank))

    def forward(self, x, scale: float):
        x, down, up = x.float(), self.down.float(), self.up.float()
        if up.ndim == 3:
            h = torch.einsum("n...c,nrc->n...r", x, down)
            return _scaled(torch.einsum("n...r,ncr->n...c", h, up), scale)
        return _scaled(F.linear(F.linear(x, down), up), scale)


def _with_lora(base_out, branch, x, scale):
    """base_out plus the LoRA branch on x, in base_out's dtype."""
    if branch is None or scale == 0:
        return base_out
    return base_out + branch(x, scale).to(base_out.dtype)


def _scaled(h, scale):
    """h * scale, without the op at scale 1 (the adapted path's every call)."""
    return h if scale == 1 else h * scale


def _upsample_nearest(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _avg_pool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class ResBlock(nn.Module):
    def __init__(self, spec: ResSpec, emb_ch: int, use_scale_shift_norm: bool,
                 dtype: torch.dtype, lora_rank: int = 0):
        super().__init__()
        self.spec = spec
        self.use_scale_shift_norm = use_scale_shift_norm
        r = lora_rank
        emb_out = 2 * spec.out_ch if use_scale_shift_norm else spec.out_ch
        self.norm1 = GroupNorm32(spec.in_ch)
        self.conv1 = Conv3x3(spec.in_ch, spec.out_ch, dtype)
        self.conv1_lora = LoRAConv(spec.in_ch, spec.out_ch, r) if r else None
        self.emb = Dense(emb_ch, emb_out, dtype)
        self.emb_lora = LoRADense(emb_ch, emb_out, r) if r else None
        self.norm2 = GroupNorm32(spec.out_ch)
        self.conv2 = Conv3x3(spec.out_ch, spec.out_ch, dtype, zero_init=True)
        self.conv2_lora = LoRAConv(spec.out_ch, spec.out_ch, r) if r else None
        self.skip = Dense(spec.in_ch, spec.out_ch, dtype) if spec.out_ch != spec.in_ch else None
        self.skip_lora = (LoRAConv(spec.in_ch, spec.out_ch, r, kernel=1)
                          if r and self.skip is not None else None)

    def forward(self, x, emb, use_kernel: bool = True, lora_scale: float = 1.0):
        h = F.silu(self.norm1(x))
        if self.spec.mode == "up":
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif self.spec.mode == "down":
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = _with_lora(self.conv1(h, use_kernel), self.conv1_lora, h, lora_scale)
        emb_in = F.silu(emb)
        emb_out = _with_lora(self.emb(emb_in), self.emb_lora, emb_in, lora_scale)[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.norm2(h) * (1 + scale) + shift
        else:
            h = self.norm2(h + emb_out)
        h = F.silu(h)
        h = _with_lora(self.conv2(h, use_kernel), self.conv2_lora, h, lora_scale)
        skip = x if self.skip is None else _with_lora(self.skip(x), self.skip_lora, x, lora_scale)
        return skip + h


class AttentionBlock(nn.Module):
    def __init__(self, spec: AttnSpec, dtype: torch.dtype, lora_rank: int = 0):
        super().__init__()
        self.spec = spec
        r = lora_rank
        self.norm = GroupNorm32(spec.ch)
        self.qkv = Dense(spec.ch, 3 * spec.ch, dtype)
        self.qkv_lora = LoRADense(spec.ch, 3 * spec.ch, r) if r else None
        self.proj = Dense(spec.ch, spec.ch, dtype, zero_init=True)
        self.proj_lora = LoRADense(spec.ch, spec.ch, r) if r else None

    def forward(self, x, use_kernel: bool = True, lora_scale: float = 1.0):
        b, hgt, wid, c = x.shape
        heads = self.spec.num_heads
        ch = c // heads
        hw = hgt * wid
        h = self.norm(x).reshape(b, hw, c)
        qkv = _with_lora(self.qkv(h), self.qkv_lora, h, lora_scale)
        # legacy order: heads split BEFORE q/k/v -> [head][q|k|v][ch]
        qkv = qkv.reshape(b, hw, heads, 3 * ch).permute(0, 2, 1, 3)    # (b, heads, hw, 3ch)
        q, k, v = (a.reshape(b * heads, hw, ch).contiguous()
                   for a in qkv.split(ch, dim=-1))
        att = attention(q, k, v, use_kernel=use_kernel)
        att = att.reshape(b, heads, hw, ch).permute(0, 2, 1, 3).reshape(b, hw, c)
        out = _with_lora(self.proj(att), self.proj_lora, att, lora_scale)
        return x + out.reshape(b, hgt, wid, c)


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
            bias = self.conv.bias.to(self.dtype)
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            if bias.ndim == 1:
                return F.conv2d(x, w, bias, stride=2, padding=1).permute(0, 2, 3, 1)
            # a bias per image (N, Cout): the conv's fp32 sums plus image n's
            # bias, rounded once to the compute dtype, as the shared bias is
            y = F.conv2d(x.float(), w.float(), None, stride=2, padding=1).permute(0, 2, 3, 1)
            return (y + bias.float()[:, None, None, :]).to(self.dtype)
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
                self.add_module(f"{prefix}_{j}", self._make(spec, dtype, self._lora_rank_for(group)))
                layers.append((f"{prefix}_{j}", spec))
            self._blocks.append((group, layers))
        last_ch = int(cfg.channel_mult[0] * mc)
        self.final_norm = GroupNorm32(last_ch)
        self.final_conv = Conv3x3(last_ch, cfg.out_channels, torch.float32, zero_init=True)

    _LORA_GROUPS = {"in": "input_blocks", "mid": "middle_block", "out": "output_blocks"}

    def _lora_rank_for(self, group: str) -> int:
        cfg = self.cfg
        return cfg.lora_rank if self._LORA_GROUPS[group] in cfg.lora_include_blocks else 0

    def _make(self, spec, dtype, lora_rank):
        cfg = self.cfg
        if isinstance(spec, ResSpec):
            return ResBlock(spec, 4 * cfg.model_channels, cfg.use_scale_shift_norm, dtype,
                            lora_rank)
        if isinstance(spec, AttnSpec):
            return AttentionBlock(spec, dtype, lora_rank)
        if isinstance(spec, SampleSpec):
            return Sample(spec, dtype)
        if isinstance(spec, ConvSpec):
            return Conv3x3(spec.in_ch, spec.out_ch, dtype)
        raise TypeError(spec)

    def _call(self, name, spec, h, emb, use_kernel, lora_scale):
        layer = getattr(self, name)
        if isinstance(spec, ResSpec):
            return layer(h, emb, use_kernel, lora_scale)
        if isinstance(spec, AttnSpec):
            return layer(h, use_kernel, lora_scale)
        return layer(h, use_kernel)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                use_kernel: bool = True, lora_scale: float = 1.0) -> torch.Tensor:
        """`use_kernel=False` runs every conv and attention through its plain
        PyTorch version on a CUDA tensor too (for comparisons only).
        `lora_scale` scales the LoRA branches (1: adapted, 0: the prior)."""
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
                h = self._call(name, spec, h, emb, use_kernel, lora_scale)
            if group == "in":
                hs.append(h)

        h = F.silu(self.final_norm(h.to(in_dtype)))
        h = self.final_conv(h, use_kernel)
        if cfg.out_channels == 2:            # learn_sigma: the mean channel
            return h[..., :1]
        return h


def count_params(params) -> int:
    """The number of values in `params`: a module's parameters, a state_dict
    or any iterable of tensors or arrays (JAX `count_params` of a tree)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return sum(math.prod(p.shape) for p in params)
