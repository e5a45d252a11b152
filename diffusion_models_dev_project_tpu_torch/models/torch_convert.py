"""Reference PyTorch checkpoints (`.pt`) -> the port's `UNetModel.state_dict()`.

Port of `models/torch_convert.py` of the JAX package.  The reference saves a
raw state_dict (`model.pt`) or an EMA state whose `shadow_params` list
follows `model.parameters()` (`ema_model.pt`).  `torch_key_map` walks the
same `build_arch_spec` that builds the UNet, in the reference constructor's
registration order, and names each torch key's place in the JAX package's
flax tree:

  torch                                  flax path
  -------------------------------------  ---------------------------
  time_embed.0 / time_embed.2            time_dense_0 / time_dense_1
  input_blocks.0.0 (stem conv)           in_0_0
  input_blocks.i.j  ResBlock             in_i_j/{norm1,conv1,emb,norm2,conv2,skip}
  input_blocks.i.j  AttentionBlock       in_i_j/{norm,qkv,proj}
  input_blocks.i.0  Downsample(.op)      in_i_0/conv
  middle_block.j                         mid_j
  output_blocks.i.j (incl. Upsample.conv)out_i_j
  out.0 / out.2                          final_norm / final_conv

with the layout changes Conv2d (O, I, kh, kw) -> (kh, kw, I, O) and Linear
or 1x1 Conv1d (O, I[, 1]) -> (I, O).  `convert_torch_state_dict` builds
that tree and hands it to `models/convert.py::params_from_flax`, so a `.pt`
file reaches the port's module names by the same last step as a flax
msgpack file.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .convert import params_from_flax
from .unet import AttnSpec, ConvSpec, ResSpec, SampleSpec, UNetConfig, build_arch_spec

__all__ = ["torch_key_map", "convert_torch_state_dict", "convert_ema_state",
           "load_torch_checkpoint"]


def _conv2d(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _dense(w):
    w = np.asarray(w)
    if w.ndim == 3:                 # conv1d (O, I, 1)
        w = w[..., 0]
    return np.transpose(w, (1, 0))


def _res_entries(tpath: str, fpath: Tuple[str, ...], spec: ResSpec):
    e = [
        (f"{tpath}.in_layers.0.weight", fpath + ("norm1", "scale"), None),
        (f"{tpath}.in_layers.0.bias", fpath + ("norm1", "bias"), None),
        (f"{tpath}.in_layers.2.weight", fpath + ("conv1", "kernel"), _conv2d),
        (f"{tpath}.in_layers.2.bias", fpath + ("conv1", "bias"), None),
        (f"{tpath}.emb_layers.1.weight", fpath + ("emb", "kernel"), _dense),
        (f"{tpath}.emb_layers.1.bias", fpath + ("emb", "bias"), None),
        (f"{tpath}.out_layers.0.weight", fpath + ("norm2", "scale"), None),
        (f"{tpath}.out_layers.0.bias", fpath + ("norm2", "bias"), None),
        (f"{tpath}.out_layers.3.weight", fpath + ("conv2", "kernel"), _conv2d),
        (f"{tpath}.out_layers.3.bias", fpath + ("conv2", "bias"), None),
    ]
    if spec.out_ch != spec.in_ch:
        e += [(f"{tpath}.skip_connection.weight", fpath + ("skip", "kernel"), _conv2d),
              (f"{tpath}.skip_connection.bias", fpath + ("skip", "bias"), None)]
    return e


def _attn_entries(tpath: str, fpath: Tuple[str, ...]):
    return [
        (f"{tpath}.norm.weight", fpath + ("norm", "scale"), None),
        (f"{tpath}.norm.bias", fpath + ("norm", "bias"), None),
        (f"{tpath}.qkv.weight", fpath + ("qkv", "kernel"), _dense),
        (f"{tpath}.qkv.bias", fpath + ("qkv", "bias"), None),
        (f"{tpath}.proj_out.weight", fpath + ("proj", "kernel"), _dense),
        (f"{tpath}.proj_out.bias", fpath + ("proj", "bias"), None),
    ]


def torch_key_map(cfg: UNetConfig) -> List[Tuple[str, Tuple[str, ...], object]]:
    """Ordered (torch key, flax path, transform) triplets for `cfg`."""
    input_blocks, middle_block, output_blocks, _ = build_arch_spec(cfg)
    entries: List[Tuple[str, Tuple[str, ...], object]] = [
        ("time_embed.0.weight", ("time_dense_0", "kernel"), _dense),
        ("time_embed.0.bias", ("time_dense_0", "bias"), None),
        ("time_embed.2.weight", ("time_dense_1", "kernel"), _dense),
        ("time_embed.2.bias", ("time_dense_1", "bias"), None),
    ]

    def one(spec, tpath, fname):
        if isinstance(spec, ConvSpec):
            return [(f"{tpath}.weight", (fname, "kernel"), _conv2d),
                    (f"{tpath}.bias", (fname, "bias"), None)]
        if isinstance(spec, ResSpec):
            return _res_entries(tpath, (fname,), spec)
        if isinstance(spec, AttnSpec):
            return _attn_entries(tpath, (fname,))
        if isinstance(spec, SampleSpec):
            sub = "conv" if spec.mode == "up" else "op"
            return [(f"{tpath}.{sub}.weight", (fname, "conv", "kernel"), _conv2d),
                    (f"{tpath}.{sub}.bias", (fname, "conv", "bias"), None)]
        raise TypeError(spec)

    for i, block in enumerate(input_blocks):
        for j, spec in enumerate(block):
            entries += one(spec, f"input_blocks.{i}.{j}", f"in_{i}_{j}")
    for j, spec in enumerate(middle_block):
        entries += one(spec, f"middle_block.{j}", f"mid_{j}")
    for i, block in enumerate(output_blocks):
        for j, spec in enumerate(block):
            entries += one(spec, f"output_blocks.{i}.{j}", f"out_{i}_{j}")
    entries += [
        ("out.0.weight", ("final_norm", "scale"), None),
        ("out.0.bias", ("final_norm", "bias"), None),
        ("out.2.weight", ("final_conv", "kernel"), _conv2d),
        ("out.2.bias", ("final_conv", "bias"), None),
    ]
    return entries


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def convert_torch_state_dict(state_dict: Dict[str, object], cfg: UNetConfig):
    """The port's state_dict (fp32 tensors on the CPU) from a reference
    torch state_dict (tensors or arrays); raises on a missing or an
    unconsumed key."""
    entries = torch_key_map(cfg)
    sd = {k: _numpy(v) for k, v in state_dict.items()}
    missing = [k for k, _, _ in entries if k not in sd]
    if missing:
        more = f" (+{len(missing) - 5} more)" if len(missing) > 5 else ""
        raise KeyError(f"missing torch keys: {missing[:5]}{more}")
    extra = set(sd) - {k for k, _, _ in entries}
    if extra:
        raise KeyError(f"unconsumed torch keys: {sorted(extra)[:8]}")
    tree: Dict = {}
    for tkey, fpath, tf in entries:
        node = tree
        for p in fpath[:-1]:
            node = node.setdefault(p, {})
        node[fpath[-1]] = (tf(sd[tkey]) if tf is not None else sd[tkey]).astype(np.float32)
    return params_from_flax(tree)


def convert_ema_state(ema_state: Dict, cfg: UNetConfig):
    """The port's state_dict from a reference EMA state (`shadow_params` in
    `model.parameters()` order, which is the state_dict's key order for this
    model: it has no buffers)."""
    entries = torch_key_map(cfg)
    shadow = ema_state["shadow_params"]
    if len(shadow) != len(entries):
        raise ValueError(f"{len(shadow)} EMA shadow parameters for {len(entries)} of the model")
    return convert_torch_state_dict({k: v for (k, _, _), v in zip(entries, shadow)}, cfg)


def load_torch_checkpoint(path: str, cfg: UNetConfig, use_ema: bool | None = None):
    """The port's state_dict from a reference `.pt` file: a raw state_dict or
    an EMA state (`use_ema=None` tells them apart by structure)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if use_ema is None:
        use_ema = isinstance(obj, dict) and "shadow_params" in obj
    return convert_ema_state(obj, cfg) if use_ema else convert_torch_state_dict(obj, cfg)
