"""Output artifacts of the CLIs: PNGs, reconstruction blobs, report.yaml.

Port of `utils/reporting.py` of the JAX package, which writes the PNG with
PIL and the report with PyYAML.  Neither is installed beside the card, so
the PNG (8-bit grayscale, one IDAT chunk) is written with `zlib` and numpy,
and the report as block-style YAML by hand: nested mappings, lists in flow
style, strings double-quoted as JSON writes them (a JSON string is a YAML
double-quoted scalar), so `yaml.safe_load` reads back the same values.
"""
from __future__ import annotations

import json
import math
import os
import re
import struct
import zlib
from typing import Dict

import numpy as np

__all__ = ["save_image_png", "save_recon_info", "write_report", "yaml_dump"]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_image_png(path, image: np.ndarray) -> None:
    """Save a [0, 1]-ish float image (H, W) as an 8-bit grayscale PNG: values
    clipped to [0, 1], times 255, truncated, as the JAX package's PIL path."""
    arr = (np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)
    if arr.ndim != 2:
        raise ValueError(f"save_image_png wants a 2-D image, got {arr.shape}")
    h, w = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr], axis=1)   # filter byte 0 per row
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)              # 8-bit grayscale
    with open(str(path), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 9)) + _chunk(b"IEND", b""))


def save_recon_info(path, recon: np.ndarray, ground_truth: np.ndarray) -> None:
    np.savez_compressed(str(path), recon=np.asarray(recon), ground_truth=np.asarray(ground_truth))


def _scalar(v) -> str:
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        v = v.item()
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        return repr(v)
    return json.dumps(str(v), ensure_ascii=False)


_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*")
_RESERVED = {"y", "n", "yes", "no", "true", "false", "on", "off", "null"}   # YAML 1.1 words


def _key(key) -> str:
    key = str(key)
    plain = _PLAIN_KEY.fullmatch(key) and key.lower() not in _RESERVED
    return key if plain else _scalar(key)


def yaml_dump(tree: Dict, indent: int = 0) -> str:
    """Block-style YAML of a nested dict of scalars and lists."""
    lines = []
    pad = " " * indent
    for key, v in tree.items():
        k = _key(key)
        if isinstance(v, dict):
            if v:
                lines.append(f"{pad}{k}:")
                lines.append(yaml_dump(v, indent + 2))
            else:
                lines.append(f"{pad}{k}: {{}}")
        elif isinstance(v, (list, tuple)):
            lines.append(f"{pad}{k}: [{', '.join(_scalar(x) for x in v)}]")
        else:
            lines.append(f"{pad}{k}: {_scalar(v)}")
    return "\n".join(lines)


def write_report(path, report: Dict) -> None:
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(str(path), "w") as f:
        f.write(yaml_dump(report) + "\n")
