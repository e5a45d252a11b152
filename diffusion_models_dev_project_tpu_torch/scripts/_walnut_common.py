"""The walnut protocol's setup, shared by `walnut_full_scale` and
`walnut_adapted` (counterpart of the repository's `scripts/_walnut_common.py`,
whose values it copies).

The CWI walnut scans are not in the repository, so the measured
`scan_geom_corrected.geom` orbit is replaced by a synthetic circular
cone-beam orbit with the CWI scanner's magnification: the source 66 mm from
the centre, the detector 199 mm from the source, 0.1496 mm pixels, 1200
angles, sub-sampled 20x in angle (60) and 6x in detector columns (128).
Every later step (the mask probe, the single-pass assembly, the `.mat`
round trip, the ELL and dense operators, FDK, DDS) is the production one.

`WalnutProtocol` bundles what `build_walnut_trafo` and the scripts read:
the default is the CWI protocol above; tests run the same code at a
miniature dataset spec (`physics/walnut.py::WalnutDatasetSpec`) and orbit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..physics.cone_beam import circular_cone_vecs
from ..physics.walnut import DEFAULT_SPEC, WalnutDatasetSpec, get_walnut_2d_ray_trafo

__all__ = ["SOD", "SDD", "PIX", "ASS", "CSS", "SLICE_CFG", "WalnutProtocol", "CWI",
           "walnut_phantom", "walnut_vecs", "build_walnut_trafo"]

# CWI walnut scanner: SOD 66 mm, SDD 199 mm, 0.1496 mm pixels
SOD, SDD, PIX = 66.0, 199.0, 0.1496
ASS, CSS = 20, 6                     # reference walnut_configs.py:21-22

# the shipped SINGLE_SLICE_CONFIGS encode the real scanner's detector row
# offset (slice_offset=3 against rows 474..482); the synthetic circular
# orbit is centred, so the slice is the centre of a 9-slice slab against
# the 9 detector-centre rows
SLICE_CFG = dict(num_slices=9, slice_offset=0, num_proj_rows=9,
                 first_proj_row=(972 - 9) // 2)


@dataclasses.dataclass(frozen=True)
class WalnutProtocol:
    """The walnut operator's geometry: the orbit (source and detector
    distances, pixel pitch), the sub-sampling, the slice and the dataset
    spec."""

    sod: float = SOD
    sdd: float = SDD
    pix: float = PIX
    ass: int = ASS
    css: int = CSS
    slice_cfg: dict = dataclasses.field(default_factory=lambda: dict(SLICE_CFG))
    spec: WalnutDatasetSpec = DEFAULT_SPEC

    @property
    def vol_size(self) -> int:
        """The side of the native slice grid (501 for the CWI walnut)."""
        return int(self.spec.vol_sz[1])


CWI = WalnutProtocol()


def walnut_phantom(n=501):
    """Walnut-like 2D phantom: shell, interior lobes, air gaps."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    r2 = xx ** 2 + (yy * 1.15) ** 2
    img = np.zeros((n, n), np.float32)
    img[r2 < 0.72 ** 2] = 0.55                           # shell
    img[r2 < 0.62 ** 2] = 0.25                           # interior
    th = np.arctan2(yy, xx)
    lobes = 0.28 * (np.cos(2 * th) ** 2) * (r2 < 0.55 ** 2)
    img += lobes.astype(np.float32)
    img[((xx - 0.15) ** 2 + yy ** 2) < 0.08 ** 2] = 0.02  # air pocket
    img[(xx ** 2 + (yy + 0.3) ** 2) < 0.05 ** 2] = 0.02
    return np.clip(img, 0, 1)


def walnut_vecs(protocol: WalnutProtocol = CWI) -> np.ndarray:
    """The synthetic circular orbit's cone_vec vectors, one per angle of the
    dataset spec (1200 for the CWI walnut)."""
    return circular_cone_vecs(protocol.spec.max_num_angles,
                              src_radius=protocol.sod, det_radius=protocol.sdd - protocol.sod,
                              det_spacing=(protocol.pix, protocol.pix))


def build_walnut_trafo(workdir, impl="dense", new_shape=(256, 256), device=None,
                       protocol: WalnutProtocol = CWI):
    """Protocol-scale walnut operator (501², 60 angles × 128 cols) on
    `device` (CUDA unless asked for another): the `.mat` in `workdir` is
    loaded, or assembled and saved there when missing (and the dense
    operator cached beside it)."""
    return get_walnut_2d_ray_trafo(
        workdir, walnut_id=1, orbit_id=2, angular_sub_sampling=protocol.ass,
        proj_col_sub_sampling=protocol.css, new_shape=new_shape, vecs_all=walnut_vecs(protocol),
        impl=impl, single_slice_config=protocol.slice_cfg, spec=protocol.spec, device=device)
