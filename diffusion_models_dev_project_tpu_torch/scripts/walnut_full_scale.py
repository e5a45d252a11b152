"""The walnut operator at the protocol's full scale, with FDK and, given a
prior, the DDS sweep (counterpart of the repository's
`scripts/walnut_full_scale.py`, with its flags, defaults and printed lines).

The protocol's shape (reference `configs/walnut_configs.py:14-30`,
`src/dataset/walnut_utils.py:1127-1166`): a 501² slice, angular
sub-sampling 1200/20 -> 60 angles, column sub-sampling 768/6 -> 128
columns, i.e. a (60·128 = 7680) x 251001 sparse system matrix, on the
synthetic circular CWI orbit of `_walnut_common.py`.  The stages:

- whether the native assembler builds;
- the ELL operator: the mask probe on the operator's device, the native
  assembly and the `.mat` save (or its load, when `--workdir` holds it),
  the matrix's shape asserted;
- the dense operator, A with the 501² -> 256² upsample folded in (2.0 GB
  fp32, cached beside the `.mat`);
- the phantom, nearest-resized to 256², observed through each operator at
  relative noise 0.05, with FDK's PSNR and SSIM and the observation's SNR;
- the ELL and dense forwards' relative difference;
- apply and adjoint times, batch 1: device time between CUDA events on the
  card (wall time on the CPU);
- with `--ckpt`, DDS of the dense observation for every combination of the
  comma lists `--eta`, `--gamma` and `--cg_iter` (time travel from
  `--travel_length`/`--travel_repeat`), a line each, then `[sweep best]`,
  and the best reconstruction in `<workdir>/dds_recon_best.npz`.

    python -m diffusion_models_dev_project_tpu_torch.scripts.walnut_full_scale \\
        --ckpt checkpoints/flagship_vesde_256_ema.msgpack.npz --eta 0.85,0.15

runs on the card; `--platform cpu` (the JAX script's flag) or `--device cpu`
runs the plain PyTorch path on the CPU.  The prior is the
ellipse-trained 256² checkpoint (`*.msgpack.npz`), loaded as
`eval_flagship_256.load_model` loads it, computing in bf16 from fp32
leaves, as the JAX script sets `config.model.dtype` and keeps its tree.

Seeds: the observation noise is drawn from a generator seeded 3, the
chain's draws from one seeded 7, where the JAX script uses `PRNGKey(3)` and
`PRNGKey(7)`.  JAX's draws cannot be reproduced in torch, so readings on
the card are compared with the JAX records, not bit for bit; the CPU tests
inject JAX's draws instead (`tests/test_torch_walnut_scripts.py`).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ._walnut_common import CWI, WalnutProtocol, walnut_phantom

parser = argparse.ArgumentParser(description="the walnut operator at full scale, FDK and DDS")
parser.add_argument("--platform", default=None, choices=[None, "cpu"],
                    help="cpu: run on the CPU (the JAX script's flag; as --device cpu)")
parser.add_argument("--ckpt", default=None, help="a 256² score prior (*.msgpack.npz); enables "
                    "the DDS reconstruction stage")
parser.add_argument("--num_channels", default=128, type=int)
parser.add_argument("--sde", default="vesde", choices=["vesde", "ddpm"],
                    help="prior family for the DDS stage (the ellipse-trained 256² checkpoint "
                         "must match)")
parser.add_argument("--num_steps", default=1000, type=int)
parser.add_argument("--eta", default="0.15",
                    help="DDIM eta for the DDS stage; a comma-separated list runs one "
                         "reconstruction per value (shared operator)")
parser.add_argument("--gamma", default="0.01", help="DDS gamma; a comma-separated list sweeps")
parser.add_argument("--cg_iter", default="5",
                    help="CG iterations per DDS step; a comma-separated list sweeps")
parser.add_argument("--travel_length", default=1, type=int, help="DDPM time-travel jump length")
parser.add_argument("--travel_repeat", default=1, type=int)
parser.add_argument("--workdir", default="outputs/walnut_full")
# the port's own
parser.add_argument("--device", default=None, help="cuda (default) or cpu")

STDDEV = 0.05           # walnut_configs: relative noise of the observation
OBS_SEED, CHAIN_SEED = 3, 7
N_REP = 20              # calls per apply / adjoint timing


def native_available() -> bool:
    """Whether the native assembler builds and loads (`physics/native.py`)."""
    from ..physics import native

    try:
        native.load_library()
    except (OSError, RuntimeError):
        return False
    return True


def expected_matrix_shape(protocol: WalnutProtocol):
    """(masked rays, pixels) of the single-slice matrix: one detector row
    per (angle, column) of the sub-sampled scan, the native grid's pixels."""
    from ..physics.walnut import first_col_for_sub_sampling

    spec = protocol.spec
    angles = len(range(0, spec.max_num_angles, protocol.ass))
    cols = len(range(first_col_for_sub_sampling(protocol.css, spec), spec.projs_cols,
                     protocol.css))
    return angles * cols, protocol.vol_size ** 2


def model_ground_truth(protocol: WalnutProtocol, size: int, device) -> torch.Tensor:
    """The phantom on the native grid, nearest-resized to (1, size, size, 1)."""
    from ..physics.ray_trafo import nearest_resize

    gt = torch.from_numpy(walnut_phantom(protocol.vol_size))[None, :, :, None].to(device)
    return nearest_resize(gt, (size, size))


def observe(x_model: torch.Tensor, rt, device, noise=None) -> torch.Tensor:
    """The noisy observation of `x_model` through `rt`: noise from a generator
    seeded `OBS_SEED` on `device`, or the standard-normal `noise`."""
    from ..physics.simulation import simulate

    g = None if noise is not None else torch.Generator(device=device).manual_seed(OBS_SEED)
    return simulate(x_model, rt, STDDEV, generator=g, noise=noise)


def _timed_ms(fn, device) -> float:
    """ms per call of `fn` over `N_REP` calls: device time between CUDA
    events on the card, wall time on the CPU."""
    fn()
    if device.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize(device)
        ev[0].record()
        for _ in range(N_REP):
            fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / N_REP
    t0 = time.perf_counter()
    for _ in range(N_REP):
        fn()
    return (time.perf_counter() - t0) / N_REP * 1e3


def load_prior(args, size: int, device, **score_kw):
    """(config, sde, model): the ellipse-trained prior of `args.ckpt` at
    `size`², bf16 compute over fp32 leaves where a layer computes in fp32
    (`eval_flagship_256.load_model`, `float32`), as the JAX scripts load it."""
    from .. import factory as F
    from ..configs.disk_ellipses_configs import get_config
    from .eval_flagship_256 import load_model

    # walnut reconstruction uses the ELLIPSES-trained prior (the reference's
    # two-axis protocol: --model_learned_on ellipses --dataset walnut)
    config = get_config(args.sde)
    config.data.im_size = config.model.image_size = size
    config.model.num_channels = args.num_channels
    config.model.dtype = "bfloat16"
    config.ckpt_path = args.ckpt
    sde = F.get_standard_sde(config)
    return config, sde, load_model(config, sde, args.ckpt, "float32", device, **score_kw)


def dds_sweep(args, model, sde, rt, obs, gt_model: np.ndarray, fdk_psnr: float, device,
              noises=None) -> dict:
    """DDS of `obs` for every (eta, gamma, cg_iter) of the comma lists in
    `args`, with the JAX script's lines; the best run's reconstruction is
    saved to `<workdir>/dds_recon_best.npz`.  `noises`, when given, holds the
    chain's standard-normal draws in place of the generator (the same for
    every run, as the JAX script samples each from `PRNGKey(7)`).  Returns
    `runs`, a dict per run (`eta`, `gamma`, `cg_iter`, `psnr`, `ssim`,
    `seconds`, the clamped `recon`), and `best` = (psnr, (eta, gamma,
    cg_iter)) or None."""
    from .. import factory as F
    from ..utils.device import synchronize
    from ..utils.metrics import PSNR, SSIM

    size = gt_model.shape[0]
    runs, best = [], (-1e9, None)
    for eta in (float(e) for e in str(args.eta).split(",")):
        for gamma in (float(g) for g in str(args.gamma).split(",")):
            for cg_iter in (int(c) for c in str(args.cg_iter).split(",")):
                sampler = F.get_standard_sampler(
                    "dds", model, sde, rt, obs, num_steps=args.num_steps,
                    im_shape=(size, size, 1), gamma=gamma, eta=eta, cg_iter=cg_iter,
                    travel_length=args.travel_length, travel_repeat=args.travel_repeat)
                g = None if noises is not None else torch.Generator(
                    device=device).manual_seed(CHAIN_SEED)
                synchronize(device)
                t0 = time.time()
                x, _ = sampler.sample(generator=g, noises=noises)
                synchronize(device)
                x = np.clip(x[0, :, :, 0].float().cpu().numpy(), 0, 1)
                dt = time.time() - t0
                p, s = PSNR(x, gt_model), SSIM(x, gt_model)
                print(f"[dds eta={eta} gamma={gamma} cg={cg_iter}] "
                      f"{p:.2f} dB / {s:.4f} SSIM in {dt:.1f}s "
                      f"({args.num_steps} steps)  "
                      f"vs FDK {fdk_psnr:.2f} dB", flush=True)
                runs.append(dict(eta=eta, gamma=gamma, cg_iter=cg_iter, psnr=p, ssim=s,
                                 seconds=dt, recon=x))
                if p > best[0]:
                    best = (p, (eta, gamma, cg_iter))
                    np.savez(os.path.join(args.workdir, "dds_recon_best.npz"),
                             recon=x, gt=gt_model, eta=eta, gamma=gamma,
                             cg_iter=cg_iter, psnr=p, ssim=s)
    if best[1] is not None:
        print(f"[sweep best] {best[0]:.2f} dB at eta/gamma/cg = {best[1]}")
    return {"runs": runs, "best": best if best[1] is not None else None}


def main(argv=None, protocol: WalnutProtocol = CWI, size: int = 256) -> dict:
    """Run the stages of `argv` (default: the command line) for `protocol`
    with a `size`² model grid.  Returns the model-grid ground truth `gt`;
    per operator (`ell_run`, `dense_run`) the observation `obs`, FDK `fdk`
    and its `fdk_psnr`, `fdk_ssim` and `snr`; the forwards' `rel_diff`, the
    timings `times` (name -> (apply ms, adjoint ms)) and, with `--ckpt`,
    `dds_sweep`'s `dds`."""
    from ..physics.walnut import load_masked_ray_trafo_matrix, matrix_filename
    from ..utils.device import resolve_device
    from ..utils.metrics import PSNR, SSIM
    from ._walnut_common import build_walnut_trafo

    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else args.device)
    os.makedirs(args.workdir, exist_ok=True)
    print(f"native C++ assembly available: {native_available()}")

    mat_file = os.path.join(args.workdir, matrix_filename(1, 2, protocol.ass, protocol.css))
    fresh = not os.path.exists(mat_file)
    t0 = time.time()
    rt_ell = build_walnut_trafo(args.workdir, impl="ell", new_shape=(size, size), device=device,
                                protocol=protocol)
    t_build = time.time() - t0
    what = "mask probe + single-pass assembly + .mat save" if fresh else ".mat load"
    print(f"[ell] operator built in {t_build:.1f}s ({what})")
    print(f"      im_shape={tuple(rt_ell.im_shape)} obs_shape={tuple(rt_ell.obs_shape)} "
          f"model grid={tuple(rt_ell.model_im_shape)}")
    mat = load_masked_ray_trafo_matrix(mat_file)
    print(f"      matrix {mat.shape}, nnz={mat.nnz} "
          f"({mat.nnz / mat.shape[0]:.0f}/row), "
          f".mat size {os.path.getsize(mat_file) / 1e6:.0f} MB")
    assert mat.shape == expected_matrix_shape(protocol), mat.shape
    del mat

    t0 = time.time()
    rt_dense = build_walnut_trafo(args.workdir, impl="dense", new_shape=(size, size),
                                  device=device, protocol=protocol)
    print(f"[dense] model-grid densify in {time.time() - t0:.1f}s "
          f"({tuple(rt_dense.matrix.shape)}, "
          f"{rt_dense.matrix.numel() * 4 / 1e9:.2f} GB fp32)")

    # ---- numerics: phantom, observation, FDK
    x_model = model_ground_truth(protocol, size, device)
    gt_model = x_model[0, :, :, 0].cpu().numpy()
    out = {"gt": gt_model}
    with torch.no_grad():
        for name, rt in (("ell", rt_ell), ("dense", rt_dense)):
            obs = observe(x_model, rt, device)
            fdk = rt.fbp(obs)
            f = fdk[0, :, :, 0].cpu().numpy()
            p, s = PSNR(f, gt_model), SSIM(f, gt_model)
            # consistency: the forward of the ground truth must dominate the noise
            y0 = rt.apply(x_model)
            snr = float(torch.linalg.vector_norm(y0) / torch.linalg.vector_norm(obs - y0))
            print(f"[{name}] FDK: {p:.2f} dB / {s:.4f} SSIM   obs SNR {snr:.1f}")
            out[name + "_run"] = dict(obs=obs, fdk=fdk, fdk_psnr=p, fdk_ssim=s, snr=snr)

        # cross-impl agreement on the forward
        ya, yb = rt_ell.apply(x_model), rt_dense.apply(x_model)
        out["rel_diff"] = float(torch.linalg.vector_norm(ya - yb) / torch.linalg.vector_norm(ya))
        print(f"ell vs dense forward rel-diff: {out['rel_diff']:.2e}")

        # ---- timing: apply / adjoint at protocol scale
        clock = "device time, CUDA events" if device.type == "cuda" else "wall time"
        out["times"] = {}
        for name, rt in (("ell", rt_ell), ("dense", rt_dense)):
            y = rt.apply(x_model)
            t_ap = _timed_ms(lambda rt=rt: rt.apply(x_model), device)
            t_ad = _timed_ms(lambda rt=rt, y=y: rt.adjoint(y), device)
            print(f"[{name}] apply {t_ap:.2f} ms, adjoint {t_ad:.2f} ms"
                  f" (batch 1, {clock}, mean of {N_REP} calls)")
            out["times"][name] = (t_ap, t_ad)

    # ---- optional: DDS reconstruction at the walnut protocol
    if args.ckpt:
        _, sde, model = load_prior(args, size, device)
        run = out["dense_run"]
        out["dds"] = dds_sweep(args, model, sde, rt_dense, run["obs"], gt_model,
                               run["fdk_psnr"], device)
    return out


if __name__ == "__main__":
    main()
