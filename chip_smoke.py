#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`diffusion_models_dev_project_tpu_torch`).

Drives the port's paths through its entry points on one CUDA device: the
flagship 256² disk-ellipse DDS reconstruction, the walnut cone-beam
protocol's DDS with CG and with the exact Woodbury solve, AAPM data through
the conditional CLI and the parallel-beam matrix operator, steerable LoRA
adaptation inside the DDS loop, four images per call through the
conditional and the adapted CLIs (`--shard_images`), DPS and naive
sampling through the conditional CLI,
score-model training through the train CLI, `full` and `decoder`
adaptation through the adapted CLI, whose gradients run through the hand
kernels' backward passes (conv3x3's input and weight gradients, the
attention backward), the 512² configuration, and the evaluation entry
points (`scripts/`):

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles `csrc/*.cu` with nvcc for sm_90a (ops/_build.py) and
   requires HGMMA (wgmma) and UTMALDG (TMA load) instructions in the SASS,
   both also in the weight gradient's `wgrad_tc_kernel` and the fp32
   forward's `conv3x3_tf32x3_kernel` by name, and HMMA (mma.sync) in the
   functions of attention_mma.cu, in both kernels of attention_bwd_mma.cu,
   in those of the fp32 attention (attention_tf32x3.cu and both kernels of
   attention_bwd_tf32x3.cu), in the three of attention_wide_mma.cu and of
   attention_wide_tf32x3.cu, and in the fp32 weight gradient's
   `wgrad_tf32x3_kernel`;
3. kernels: runs each kernel's wrapper at every shape the UNet forward
   gives it (recorded with forward hooks), checks it against its plain
   PyTorch version, and times kernel, plain version and library yardstick;
   each redesigned kernel (conv3x3 `tc`, attention `mma`) also against the
   CUDA-core `simt` kernel it replaced at the same shapes, for bitwise equal
   output over two launches, and at added shapes (conv3x3: batch 2, H != W,
   the largest split of K, 64 and 192 channels; attention: ragged T, other
   head widths up to 256, T = 1024); attention also against each SDPA
   backend that takes the inputs; `mma`'s saved log-sum-exp against a
   plain one, its output equal with and without it, and its time with it.
   Then the backward kernels: the conv3x3 input gradient (and the bias
   gradient) at every conv shape against autograd of the plain version, and
   the attention backward, each variant that takes the shape (`mma` with
   the forward's log-sum-exp, `simt`), at the path's shapes and added ones
   (T = 1 to 1024, ragged T, d = 8 to 256, fp32 and bf16) against its plain
   twin, each bitwise equal over two launches and timed beside its plain
   twin, cuDNN's `conv2d_input` or SDPA's backward, and its bound; `mma`
   must take at most a third of `simt`'s time per UNet backward and less
   than the plain twin's (the stem's `narrow` input gradient timed apart).
   Last the conv3x3 weight gradient (csrc/conv3x3_wgrad_tc.cu `tc`;
   csrc/conv3x3_wgrad.cu `narrow_out`, `narrow_in`, `mma`, `simt`) at every
   conv shape of a batch-3 training forward and of a batch-1 forward, in
   both I/O types, and at added shapes (H != W, boxes ragged in H and W,
   64, 192 and 384 input channels, an 8² map at batch 1, the largest split,
   the narrow kernels with a few small channels, `mma`), against its plain
   twin within `TOL_WGRAD`, bitwise equal over two launches, every `tc`
   grid within one wave of the card's clusters; timed per UNet backward
   beside the plain twin, cuDNN's `conv2d_weight` and the bound, with the
   split-K reduction timed alone; per batch-3 backward the stem's and
   final conv's narrow kernels together must be no slower than cuDNN on
   those two shapes, and `tc`'s ratio to cuDNN on its shapes is printed.
   The fp32 route (the CLIs' default dtype; TF32 off in cuDNN and in
   matmuls): at every shape `tf32x3` takes (60 a pass) the forward, the
   input gradient and the weight gradient at batch 3 and 1, each within
   `TOL["float32"]` (`TOL_WGRAD`) of the plain version and bitwise equal
   over two launches, timed beside the forced `simt` kernel, the plain
   version, cuDNN fp32 and both bounds (three TF32 products at 495
   TFLOP/s; the fp32 CUDA cores at 67); per forward, per input-gradient
   backward and per batch-3 weight-gradient backward `tf32x3` must take at
   most half of forced `simt`'s time; after an Adam step of its weight
   `tf32x3` must use the updated weight (its split copy is cached on the
   weight by version); the fp32 attention (`tf32x3`, forward and backward,
   checked with the other attention shapes: T = 1 to 1024, ragged T, d = 8
   to 128, the path's shapes at batch 1 and 3, lse2 against a plain one,
   bitwise equal over two launches, the forced `simt` kernel checked too)
   per pass at batch 1 and 3 beside forced `simt`, the plain version, SDPA
   in fp32 and both bounds: each pass at most half of forced `simt`'s time.
   Heads past 128 (`WIDE_HEADS`: d = 136 to 512, T = 64 to 1024, B·heads
   1 to 24, and `WIDE_CHECKED`: ragged T, scalar loads; fp32 and bf16):
   `mma` and `tf32x3` in column chunks (csrc/attention_wide_*.cu) forward
   and backward against the plain versions, lse2 against a plain one,
   bitwise equal over two launches, exact launch counts (no `simt`, every
   launch a wide one), each pass timed beside forced `simt` (gate: at most
   half of its time at every `WIDE_HEADS` shape), the plain versions,
   SDPA and both bounds;
4. UNet: one full-width forward of the shipped VESDE prior at 256², batch 1,
   with the kernels against `use_kernel=False`;
5. gradient: the same prior with LoRA rank 4 (up-projections drawn nonzero),
   the gradient of the adaptation loss (score -> Tweedie -> cg(1) ->
   mean((Ax - y)²) + 1e-6 TV) for every trainable leaf, in bf16 with the
   kernels against `use_kernel=False`, both against an fp32 plain
   gradient, and in fp32 with the kernels against it; the launch counts of
   one forward and backward;
5b. wide heads: the same UNet with random weights and `num_head_channels`
   -1, with 2 heads (its attention at d = 256) and 1 head (d = 512), LoRA
   rank 4, in bf16 and fp32: one forward at 256² against
   `use_kernel=False`, and phase 5's gradient under phase 5's gates; 4 wide
   attention forwards and 4 backwards a pass, counts exact;
6. DDS: reconstructs the first images of the shipped val set (`PHASE6_STEPS`
   = 100 steps,
   60 angles, noise 0.01, gamma 0.01, eta 0.85, 5 CG iterations) and requires each to
   beat its FBP in PSNR, with the kernel launch counts of the run checked
   (per forward 62 conv3x3, of which 60 tc, 1 narrow, 1 simt, and 4
   attention, all mma; per backward 4 attention backwards, all mma); CUDA
   events around the score call and the CG solve
   of the loop's last steps split a step into UNet, CG and the rest;
7. adapted: LoRA-adapted DDS (50 outer x 10 inner Adam steps, the
   protocol, on the OOD bars; val image 0 at `PHASE7_VAL_OPTIM` = 5; rank 4,
   lr 1e-3, TV 1e-6, eta 0.85, cg(1), add_cg) of val image 0 and of an OOD
   bars phantom; each must beat its FBP (at 50 outer steps or more; a
   shortened probe is not gated); a plain DDS of as many steps on the same
   observation is printed beside it; CUDA events split each outer step into
   the adaptation and the two score forwards; the launch counts are checked;
8. DPS: the gradient DPS takes in x, of ||y - A·Tweedie(score(x, t), x, t)||
   at t = 0.5 on val image 0, in bf16 and in fp32 with the kernels against
   `use_kernel=False`, with the launch counts of one forward and backward
   (per backward also the stem's input gradient, on `narrow`) and its wall
   and device times; then DPS and naive (penalty 10) through the port's
   conditional CLI on its default data (test-fold image 0, generated at
   256²), each started from the prior (on a 100-step grid; their PSNR
   printed) and from the FBP (the last 500
   steps of the 1000-step grid): each run inside the CLI's divergence
   guard, every run with its launch counts exact; from the FBP, DPS better than naive by
   `DPS_MARGIN_DB` (on the 1000-step grid or finer); CUDA events splitting
   a DPS step into the score's forward and backward and the rest;
9. training: the flagship warm-started from the shipped VESDE prior, fp32
   masters under bf16 compute, batch 3: the first step's loss and gradient
   of every parameter, kernels against plain in bf16 and fp32 (the gates of
   phase 5), with its launch counts (62 conv3x3 forwards, 62 weight
   gradients: 60 `tc`, 1 `narrow_in`, 1 `narrow_out`; 61 input gradients,
   4 + 4 attention); then the train CLI
   (`--init_ckpt`, `--lr_warmup`, `--keep_best_probe dds`) for
   `TRAIN_STEPS` steps: exact launch counts, the plain weight gradient
   never on CUDA, every step's loss at most `TRAIN_LOSS_RATIO` times the
   warm-start prior's on the same batch, t and z, wall ms per step, device
   ms of a step's forward and backward, peak memory, the exported
   `best_ema.msgpack.npz` equal to the EMA shadow in fp16, and the probe's
   200-step DDS (the shadow cast to bf16, as the JAX trainer probes it)
   better than FBP on its images; then, printed and not gated, 4 steps each
   from the CLI's masters (rounded to bf16) and from masters left at the
   checkpoint's fp16 values, their losses and probes (`WITNESS_PROBE_STEPS`
   = 50 DDS steps; what the rounding guards against); then DDPM from the
   fresh init (output exactly
   0, the epsilon loss finite, counts exact);
10. full and decoder: the full-width gradient of the adaptation loss under
   each strategy, kernels against plain with the gates of phase 5 and launch
   counts derived from the model's structure; a short run of each through
   the adapted CLI (finite, PSNR printed and not gated);
10b. the CLIs at their default compute dtype (fp32, no `--dtype`): the
   adapted CLI's LoRA run (`FP32_ADAPT_STEPS` x `FP32_ADAPT_OPTIM`, add_cg)
   on val image 0, beside the same run in bf16, and the train CLI
   warm-started for `FP32_TRAIN_STEPS` steps at batch 3: launch counts exact
   (per forward 60 `tf32x3`, 1 `narrow`, 1 `simt` and 4 `tf32x3`
   attention; per backward 60 `tf32x3` input gradients, 4 `tf32x3`
   attention backwards and, training, 60 `tf32x3` weight gradients), the
   plain weight gradient never on CUDA, finite
   results; ms per outer step and per training step beside bf16's;
11. several images per call (`SHARD_IMAGES` = 4) on the one card: 11a the
   forward kernels with a bias per image, (4, Cout), at every conv shape of
   a batch-4 forward in both I/O types (`tc` and `tf32x3` with one split
   and with several, `narrow`, `simt`, and `simt` at their shapes) within `TOL`
   of `conv3x3_reference`, bitwise equal to the shared-bias launch when the
   four rows are equal, the bias gradient per image against autograd of
   the plain version; timed per batch-4 forward beside cuDNN (shared bias)
   and the bound; 11b the conditional CLI with `--shard_images 4
   --num_images 4` (DDS, η 0.85, `SHARD_DDS_STEPS` steps) and the first
   `SHARD_SERIAL_IMAGES` = 1 of the images serially: each batched image
   beats its FBP, each serial one's batched twin lies within
   `SHARD_DDS_AGREE_DB` of it, launch counts exact (62 conv3x3 and 4
   attention per batch-4 forward); seconds per image at 1 and 4, the step
   split by CUDA events, the device's busy share (bounded by graph replay,
   and read from `torch.profiler` traces of a few steps at 1 and 4 images:
   the union of the device events over the wall time); 11c adapted
   `lora`: the full-width gradient of the batched adaptation loss for 2
   images (val images 0 and 1, each its own LoRA), each image's rows with
   phase 5's gates (bf16 kernels against bf16 plain, batched; both against
   the image's serial fp32 gradient; fp32 kernels, batched, against it per
   leaf); the batched chain (`sample_batched`, fp32 with the kernels, 2
   images, injected draws, `SHARD_CHAIN_STEPS` x `SHARD_CHAIN_OPTIM`)
   within `TOL_SHARD_CHAIN` of each image's serial chain by tensors; then
   the adapted CLI with `--shard_images 4` cut to 5 x 3 and the first
   image serially, its batched PSNR within `SHARD_ADAPT_AGREE_DB` of its
   serial run (against FBP printed, not gated: 5 x 3 does not
   reconstruct), launch counts exact, seconds per image at 1 and 4, busy
   share (graph replay, and profiler traces of `SHARD_TRACE_STEPS` outer
   steps) and peak memory;
12. walnut: the cone-beam walnut protocol at full scale on the synthetic
   centred CWI orbit (501² slice, 60 angles x 128 columns; the port's
   `scripts/_walnut_common.py`): the mask probe
   on the card, the native assembly (its rows held to the plain numpy
   assembly on 256 random rays), the `.mat` round trip (bit-equal), the
   dense model-grid operator formed on the card, FDK; the port's
   `scripts/walnut_full_scale.py` in-process without `--ckpt` on the same
   work directory (its `.mat` and dense cache loaded, its FDK equal to this
   phase's to 1e-6 dB); gates: ELL forward
   against dense, the dense adjoint, the Woodbury residual; device times of
   apply, adjoint, CG(5), the Woodbury step and S⁻¹'s build beside their
   bounds; then DDS with the shipped prior (`WALNUT_STEPS` = the
   protocol's 1000 steps, γ 0.01, η 0.85),
   with CG(5) and with the exact Woodbury solve, each better than FDK by
   `WALNUT_MARGIN_DB` and the two within `WALNUT_AGREE_DB` of each other,
   launch counts exact, each step split into UNet, data consistency and
   rest;
12b. walnut adapted: the LoRA adaptation loss's full-width gradient through
   the dense operator, kernels against plain with phase 5's gates, then a
   cut 5 x 3 adapted run through the port's `scripts/walnut_adapted.py`
   in-process with the script's defaults (`--sde vesde`, the prior the copy
   holds; CG(5) in the loss, no CG in the step; PSNR printed, not gated),
   launch counts exact;
13. AAPM: synthetic slices (scripts/make_synth_aapm.py, run, not edited);
   DDS through the conditional CLI (`--dataset aapm`, ellipse prior,
   `AAPM_STEPS` = 100 of the protocol's 1000 steps, η 0.85) better than FBP; DDS through the parallel-beam matrix
   operator (Joseph, ELL) on AAPM val image 0 better than FBP; the AAPM
   config's UNet at full width (256 channels, random weights) against its
   plain path with exact launch counts, and its conv3x3 shapes timed by
   variant;
14. multi-card (`parallel/launch.py`): one rank per card over NCCL where
   the machine has several cards, else two ranks sharing the one card over
   gloo (printed); every rank runs the hand kernels.  14a the train CLI
   warm-started, `MC_TRAIN_BATCH` = 6 over 2 ranks (3 rows a rank),
   `MC_TRAIN_STEPS` = 4 steps: after every step the replicas bitwise equal,
   and each step's loss (the mean over the ranks) within `MC_LOSS_RTOL` and
   its all-reduced gradient over all leaves within `TOL_GRAD_ALL` of the
   one-process step at batch 6 on the same parameters, t and z; launch
   counts exact per rank; 14b the conditional CLI at `--shard_images 4`
   (phase 11b's run, sharded): each image above its FBP and within
   `MC_DDS_AGREE_DB` of phase 11b's one-card batch-4 run, launch counts
   exact per rank, and an fp32 DDS chain of 2 images x 4 steps, sharded,
   within `TOL_SHARD_CHAIN` of one process by tensors; 14c the adapted CLI
   at `--shard_images 4` (5 x 3, phase 11c's run, sharded), counts exact,
   and phase 11c's fp32 `sample_batched` (2 images, 4 x 3) sharded within
   `TOL_SHARD_CHAIN` of one process.  Printed: the layout, seconds per
   image at 1 rank (phase 11) and at 2, the busy share per rank from
   profiler traces, the launches per rank summed.  `--phase14` runs it
   alone after phases 1 and 2, against one-card runs of its own;
15. the 512² configuration (`scripts/smoke_512.py`: channel_mult (0.5, 1,
   1, 2, 2, 4, 4) at 128 channels, random weights) and the evaluation entry
   points: 15a every conv3x3 and attention shape of its forward (its
   attention runs at the 16² and 8² maps: the flagship's (8, 256, 64) and
   (8, 64, 64)), and attention at (4, 1024, 64), off the path, against
   their plain versions (phase 3's tolerances), timed beside the plain
   versions, cuDNN, SDPA and the bound (no speed gate);
   15b the forward at full width with every leaf drawn nonzero against the
   plain path within `TOL_UNET`, launch counts exact (each call on the
   variant its plan picks); 15c the 512² DDS through the smoke entry point
   (`DDS_512_STEPS` = 20 of its 100 steps, γ 10, CG(10)): finite, counts
   exact, PSNR against FBP printed (an untrained prior), the step split into
   UNet, CG and rest; 15d `scripts/eval_flagship_256.py` in-process (VESDE,
   η 0.85, 2 val images, 50 steps): each image above its FBP, its printed
   lines parsed, counts exact; `scripts/eval_adapted_256.py` on the OOD
   bars (5 x 3, DDS 50 steps): finite, counts exact.  `--phase15` runs it
   alone after phases 1 and 2;
16. prints one `{"kernels": [...]}` line (with the 512² rows and the fp32
   route's `conv3x3_tf32x3`, `conv3x3_weight_grad_tf32x3`, `attention_tf32x3`
   and `attention_backward_tf32x3`), then, last,
   the device line `{"ok": true, "device": {...}}`.

Any failed check raises, so the script exits non-zero and prints no result.
Usage: python3 chip_smoke.py [--steps N] [--images N] [--adapt-steps N] [--adapt-images N]
       [--dps-steps N] [--phase14] [--phase15]
(walnut_probe.py runs phases 12, 12b and 13 alone, at any depth and ungated)
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "flagship_vesde_256_ema.msgpack.npz")
VALSET = os.path.join(REPO, "data_assets", "disk_ellipses_val_256.npz")

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, TF32
# tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
# TF32 products per fp32 product in the `tf32x3` kernels (hi*hi, hi*lo, lo*hi):
# their bound is TF32_PRODUCTS x FLOPs at the TF32 rate
TF32_PRODUCTS = 3
PEAK_BYTES = 3.35e12
# kernel vs plain version on the same inputs: max|diff| / max|plain|.  bf16
# output is rounded once from an fp32 sum in either version; a different
# summation order may flip that rounding by one bf16 ulp (2^-8 relative).
TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# whole UNet, kernels against plain versions: one-ulp bf16 flips propagate
# through ~30 residual blocks
TOL_UNET = 5e-2
# full-width LoRA gradient (|g_a - g_b| / |g_b|, 2-norms): bf16 kernels
# against bf16 plain over all trainable leaves; per leaf, the bf16 kernels'
# distance from the fp32 plain gradient, at most twice the bf16 plain path's
# own distance or 5e-2, whichever is larger (bf16 rounding alone moves a
# single leaf by up to ~7% either way); fp32 kernels against fp32 plain per
# leaf, free of bf16 rounding
TOL_GRAD_ALL = 2e-2
TOL_GRAD_LEAF_FACTOR = 2.0
TOL_GRAD_LEAF = 5e-2
TOL_GRAD_FP32 = 1e-3
# conv3x3 weight gradient against its plain twin on the same (bf16-rounded)
# inputs: both sum the same fp32 products over K (up to 196,608 pixels) in
# another order; max|diff| / max|plain|
TOL_WGRAD = 1e-4
LORA_RANK = 4
TRAIN_BATCH = 3               # the config's training.batch_size
TRAIN_STEPS = 4               # steps of the warm-started training run through the CLI
TRAIN_WARMUP = 100            # its --lr_warmup (a fresh Adam on a warm start)
# every training step's loss at most this times the warm-start prior's loss on
# the same batch, t and z: the first steps move each value by at most 1e-5
TRAIN_LOSS_RATIO = 1.02
TRAIN_WITNESS_STEPS = 4       # steps of the bf16-tie witness (phase 9b'; cut, PERF.md §4)
DDPM_TRAIN_STEPS = 2          # steps of the DDPM run from the fresh init
PROBE_DDS_STEPS = 200         # the keep-best probe's DDS (run_score_based_models_train.py)
WITNESS_PROBE_STEPS = 50      # the witnesses' probe DDS (phase 9b'; cut, PERF.md §4)
ADAPT_CLI_STEPS, ADAPT_CLI_OPTIM = 3, 3     # the short full and decoder runs through the CLI
# phase 10b, the CLIs at their default compute dtype (fp32): the adapted CLI's
# LoRA run on val image 0 (outer x Adam steps, and the same in bf16 beside
# it) and the train CLI's warm-started steps
FP32_ADAPT_STEPS, FP32_ADAPT_OPTIM = 5, 3
FP32_TRAIN_STEPS = 3
ADAPT_PROTOCOL_STEPS = 50     # outer steps of the adapted protocol (10 Adam steps each)
ADAPT_PROTOCOL_OPTIM = 10
# phase 7 runs the protocol on the OOD bars, where adaptation matters most,
# and val image 0 at 5 Adam steps an outer step (it beat FBP by 3.4 dB at
# 50 x 5), to keep the run inside its time limit (PERF.md §4)
PHASE7_VAL_OPTIM = 5
DPS_PROTOCOL_STEPS = 1000     # steps of the conditional CLI's protocol
# cut to keep the run inside its time limit (PERF.md §4): phase 6's DDS (as
# the AAPM runs'), and the grid of phase 8's runs from the prior (known
# negative results, their PSNR printed and not gated; the CLI's divergence
# guard is gated on this grid as on the protocol's)
PHASE6_STEPS = 100
DPS_PRIOR_STEPS = 100
DPS_PENALTY = 10.0            # the best DPS penalty of the JAX package's records (BENCH.md)
DPS_T = 0.5                   # the time at which the full-width gradient in x is checked
# the FBP start skips this part of the 1000-step grid (the CLI's
# --pct_chain_elapsed), where the shipped prior's score is biased (BENCH.md;
# PERF.md §6)
DPS_FBP_PCT = 0.5
# from the FBP, DPS must beat naive on the same observation by this much on
# the 1000-step grid (dB): half the margin of a probe of both runs (12.54 dB,
# conditional_probe.py), set before the full run (PERF.md §6)
DPS_MARGIN_DB = 6.0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls captured in one CUDA graph
    and replayed, timed with CUDA events after one warm-up replay: the
    device's time without the host's Python and launch overhead, which at
    small shapes exceeds the kernels' own (inputs hot in L2)."""
    import torch

    # warm up and capture on one side stream: a backward captured by autograd
    # needs the gradient accumulators it meets to live on the capture stream
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean time of `fn` over `reps` eager back-to-back calls (CUDA events),
    after one warm-up call: what a caller waits, host overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host microseconds per call of `fn` (launches enqueued, not waited for)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


class StepTimer:
    """CUDA events around the score call and the CG solve of each DDS step
    from `first_step` on: the UNet, CG and the rest of a step, measured in
    the loop's own steps.  Events on one stream complete in order, so a
    step (one score call to the next) is the sum of the three parts."""

    def __init__(self, score_fn, cg_fn, first_step: int):
        self.score_fn, self.cg_fn, self.first_step = score_fn, cg_fn, first_step
        self.steps, self.calls, self.end = [], 0, None

    @staticmethod
    def _event():
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def score(self, x, t):
        self.calls += 1
        if self.calls <= self.first_step:
            return self.score_fn(x, t)
        start = self._event()
        out = self.score_fn(x, t)
        self.steps.append([start, self._event()])
        return out

    def cg(self, *args, **kwargs):
        if self.calls <= self.first_step:
            return self.cg_fn(*args, **kwargs)
        self.steps[-1].append(self._event())
        out = self.cg_fn(*args, **kwargs)
        self.steps[-1].append(self._event())
        return out

    def finish(self):
        self.end = self._event()

    def split(self):
        """Per timed step, ms of the step, the UNet, CG and the rest."""
        self.end.synchronize()
        rows = []
        for i, (s0, s1, c0, c1) in enumerate(self.steps):
            nxt = self.steps[i + 1][0] if i + 1 < len(self.steps) else self.end
            step, unet, cg = s0.elapsed_time(nxt), s0.elapsed_time(s1), c0.elapsed_time(c1)
            rows.append({"step": step, "unet": unet, "cg": cg, "rest": step - unet - cg})
        return rows


SPLIT_STEPS = 200    # DDS steps at the end of each image whose parts are timed


def bound(flops: float, nbytes: float, dtype: str):
    """(bound_ms, bound_by, ops_ms, bytes_ms): the least time for `flops`
    operations of `dtype` and `nbytes` of device memory traffic."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


FP32_KEYS = ("ms", "simt_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms",
             "fp32_bound_ms", "gflop")


def fp32_row(label, n, fn, simt_fn, plain_fn, library_fn, flops, nbytes, reps):
    """Time one `tf32x3` shape of the fp32 route: the kernel, the forced
    `simt` kernel, the plain version and the cuDNN fp32 call (TF32 off), each
    by graph replay, with both bounds; print the row and return it."""
    row = dict(ms=time_ms(fn, reps), simt_ms=time_ms(simt_fn, 2), plain_ms=time_ms(plain_fn, 2),
               library_ms=time_ms(library_fn, reps), gflop=flops / 1e9)
    # the tf32x3 design's least time (its TF32 products at the TF32 rate, or
    # the bytes), and any fp32 CUDA-core kernel's
    row["bound_ms"], _, row["ops_ms"], row["bytes_ms"] = bound(TF32_PRODUCTS * flops, nbytes, "tf32")
    row["fp32_bound_ms"] = bound(flops, nbytes, "float32")[0]
    log(f"{label} {n:>3} {'tf32x3':>7} fp32: kernel {row['ms']:.4f} ms, simt {row['simt_ms']:.4f}, "
        f"plain {row['plain_ms']:.4f}, cuDNN {row['library_ms']:.4f}; bounds {row['bound_ms']:.5f} "
        f"({TF32_PRODUCTS} TF32 products), {row['fp32_bound_ms']:.5f} (fp32 cores)")
    return row


def fp32_summary(what, tot, gate=True):
    """Print the fp32 route's totals per pass and gate `tf32x3` at half of
    the forced `simt` kernel's time."""
    import torch

    log(f"{what} in fp32 ({tot['calls']} tf32x3 calls; cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}): "
        f"tf32x3 {tot['ms']:.3f} ms, forced simt {tot['simt_ms']:.3f} ms "
        f"({tot['ms'] / tot['simt_ms']:.3f}x), plain {tot['plain_ms']:.3f} ms, cuDNN fp32 "
        f"{tot['library_ms']:.3f} ms ({tot['ms'] / tot['library_ms']:.3f}x); bounds "
        f"{tot['bound_ms']:.4f} ms ({TF32_PRODUCTS} TF32 products at 495 TFLOP/s, "
        f"{tot['bound_ms'] / tot['ms']:.1%} of it reached), {tot['fp32_bound_ms']:.4f} ms (fp32 "
        f"CUDA cores at 67 TFLOP/s); {tot['gflop'] / tot['ms']:.1f} TFLOP/s of fp32 work")
    if gate and not 2 * tot["ms"] <= tot["simt_ms"]:
        raise AssertionError(f"{what}: tf32x3 takes more than half of the simt kernel's time")


def rel_err(out, ref) -> tuple:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def record_shapes(model):
    """Forward hooks that record each conv3x3 and attention call's shapes."""
    from diffusion_models_dev_project_tpu_torch.models import unet as U

    seen = {"conv": [], "attn": []}

    def conv_hook(mod, args):
        x = args[0]
        seen["conv"].append((tuple(x.shape), mod.weight.shape[-1], str(mod.dtype).split(".")[-1]))

    def attn_hook(mod, args):
        b, h, w, c = args[0].shape
        heads = mod.spec.num_heads
        seen["attn"].append(((b * heads, h * w, c // heads), str(mod.qkv.dtype).split(".")[-1]))

    handles = []
    for m in model.modules():
        if isinstance(m, U.Conv3x3):
            handles.append(m.register_forward_pre_hook(conv_hook))
        elif isinstance(m, U.AttentionBlock):
            handles.append(m.register_forward_pre_hook(attn_hook))
    return seen, handles


def conv_inputs(xshape, cout, dt, gen):
    import torch

    cin = xshape[-1]
    tdt = getattr(torch, dt)
    x = torch.randn(xshape, generator=gen, device="cuda").to(tdt)
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda") / math.sqrt(9 * cin)).to(tdt)
    bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    return x, wt, bias


def check_conv_once(xshape, cout, dt, gen, splits=None):
    """One kernel call against the plain version; for tc also a second call,
    which must give the same bits.  Returns (inputs, plan, max|diff|, rel)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    b, h, w, cin = xshape
    x, wt, bias = conv_inputs(xshape, cout, dt, gen)
    p = C.plan(b, h, w, cin, cout, x.dtype, splits=splits)
    out = C.conv3x3(x, wt, bias, splits=splits)
    ref = C.conv3x3(x, wt, bias, use_kernel=False)
    torch.cuda.synchronize()
    d, r = rel_err(out, ref)
    if not (torch.isfinite(out).all() and r <= TOL[dt]):
        raise AssertionError(f"conv3x3 {p.variant} {xshape}->{cout} {dt}: rel err {r:.3e} > {TOL[dt]}")
    if p.variant in ("tc", "tf32x3"):
        again = C.conv3x3(x, wt, bias, splits=splits)
        if not torch.equal(out, again):
            raise AssertionError(f"conv3x3 {p.variant} {xshape}->{cout}: two launches differ")
    return (x, wt, bias), p, d, r


def check_conv(shapes, gen, extras=True):
    """Kernel vs plain at every distinct conv shape in both I/O types, timed
    in the path's type beside the plain version, cuDNN and the bound; at the
    shapes `tc` takes, also the CUDA-core `simt` kernel in the same run; and
    the fp32 route at the shapes `tf32x3` takes (`fp32_row`), its total per
    forward in `tot["fp32"]`, gated at half of forced `simt`'s.  Added
    shapes are checked, not timed.  Returns per-forward totals.  Without
    `extras` (another model's shapes) neither `simt` nor the fp32 route nor
    the added shapes nor the host's time per call are measured."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms", "simt_ms", "gflop")
    tot = dict.fromkeys(keys, 0.0)
    by_variant, by_map = {}, {}
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs = 0.0
    tot32, max_abs32 = dict.fromkeys(FP32_KEYS, 0.0), 0.0
    tot32["calls"] = 0
    log(f"{'shape (B,H,W,Cin->Cout)':>28} {'dtype':>8} {'n':>3} {'variant':>7} {'splits':>6} "
        f"{'kernel_ms':>10} {'simt_ms':>9} {'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} "
        f"{'bound_by':>10} {'rel_err':>9}")
    for (xshape, cout, dtype), n in sorted(counts.items(), key=lambda kv: (-kv[0][0][1], kv[0][0][3])):
        b, h, w, cin = xshape
        for dt in ("bfloat16", "float32"):     # correctness in both I/O types
            (x, wt, bias), p, d, r = check_conv_once(xshape, cout, dt, gen)
            worst[dt] = max(worst[dt], r)
            if dt == "float32" and p.variant == "tf32x3" and extras:
                max_abs32 = max(max_abs32, d)
                xl = x.permute(0, 3, 1, 2)
                wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                row = fp32_row(
                    f"{str((b, h, w, cin)) + '->' + str(cout):>28}", n,
                    lambda: C.conv3x3(x, wt, bias), lambda: C.conv3x3(x, wt, bias, variant="simt"),
                    lambda: C.conv3x3(x, wt, bias, use_kernel=False),
                    lambda: F.conv2d(xl, wl, bias, padding=1), 2.0 * b * h * w * cin * cout * 9,
                    4.0 * (x.numel() * (1 + cout / cin) + wt.numel() + cout), 10 if h >= 128 else 30)
                for key in FP32_KEYS:
                    tot32[key] += n * row[key]
                tot32["calls"] += n
            if dt != dtype:
                continue
            max_abs = max(max_abs, d)
            xl = x.permute(0, 3, 1, 2)                          # channels-last NCHW view
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bl = bias.to(x.dtype)
            reps = 20 if h >= 128 else 50
            k_ms = time_ms(lambda: C.conv3x3(x, wt, bias), reps)
            s_ms = 0.0
            if p.variant == "tc" and extras:
                s_ms = time_ms(lambda: C.conv3x3(x, wt, bias, variant="simt"), max(reps // 4, 5))
            p_ms = time_ms(lambda: C.conv3x3(x, wt, bias, use_kernel=False), max(reps // 4, 5))
            l_ms = time_ms(lambda: F.conv2d(xl, wl, bl, padding=1), reps)
            flops = 2.0 * b * h * w * cin * cout * 9
            nbytes = x.numel() * x.element_size() * (1 + cout / cin) + wt.numel() * wt.element_size() + 4 * cout
            b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
            log(f"{str((b, h, w, cin)) + '->' + str(cout):>28} {dt:>8} {n:>3} {p.variant:>7} {p.splits:>6} "
                f"{k_ms:>10.4f} {s_ms:>9.4f} {p_ms:>9.4f} {l_ms:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
            row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, ops_ms=ops_ms,
                       bytes_ms=bytes_ms, simt_ms=s_ms, gflop=flops / 1e9)
            for agg in (tot, by_variant.setdefault(p.variant, dict.fromkeys(keys, 0.0)),
                        by_map.setdefault(h, dict.fromkeys(keys, 0.0))):
                for key in keys:
                    agg[key] += n * row[key]
                agg["calls"] = agg.get("calls", 0) + n
    # checked only: batch 2, H != W with ragged tiles, the largest split,
    # Cin = Cout = 64 (half of a 128-channel tile), Cout = 192
    extra = [] if not extras else [((2, 32, 32, 256), 256, None), ((1, 16, 48, 128), 128, None),
             ((1, 8, 8, 1024), 512, 144), ((1, 32, 32, 64), 64, None),
             ((1, 12, 20, 128), 192, None)]
    # and in fp32: tf32x3 at batch 2, the ragged map, the largest split;
    # simt at channels that are no multiple of 64
    extra = [(xs, cout, splits, "bfloat16") for xs, cout, splits in extra]
    if extras:
        extra += [((2, 32, 32, 256), 256, None, "float32"), ((1, 12, 20, 128), 192, None, "float32"),
                  ((1, 8, 8, 1024), 512, 144, "float32"), ((1, 12, 20, 48), 80, None, "float32")]
    for xshape, cout, splits, dt in extra:
        _, p, _, r = check_conv_once(xshape, cout, dt, gen, splits=splits)
        worst[dt] = max(worst[dt], r)
        log(f"{str(xshape) + '->' + str(cout):>28} {dt:>8} {'-':>3} {p.variant:>7} {p.splits:>6} "
            f"{'':>10} {'':>9} {'':>9} {'':>10} {'':>9} {'':>10} {r:>9.2e}")
    if extras:
        x, wt, bias = conv_inputs((1, 8, 8, 512), 512, "bfloat16", gen)
        xl = x.permute(0, 3, 1, 2)
        wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        host = {name: host_us(fn, 200) for name, fn in (
            ("tc", lambda: C.conv3x3(x, wt, bias)),
            ("cuDNN", lambda: F.conv2d(xl, wl, bias.to(x.dtype), padding=1)))}
        log(f"host time per call at (1, 8, 8, 512)->512, enqueue only: conv3x3 (tc) "
            f"{host['tc']:.1f} us, F.conv2d {host['cuDNN']:.1f} us")
    log(f"conv3x3 max rel err: bf16 {worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), "
        f"fp32 {worst['float32']:.3e} (tol {TOL['float32']}); tc and tf32x3 bitwise equal over two "
        "launches")
    log(f"{'per UNet forward':>28} {'calls':>5} {'kernel_ms':>10} {'TFLOP/s':>8} {'of bound':>8} "
        f"{'simt_ms':>9} {'cuDNN_ms':>9} {'bound_ms':>9}")
    for name, agg in ([(f"map {h}x{h}", by_map[h]) for h in sorted(by_map, reverse=True)]
                      + [(f"variant {v}", by_variant[v]) for v in C.VARIANTS if v in by_variant]
                      + [("all", tot)]):
        log(f"{name:>28} {agg.get('calls', 0):>5} {agg['ms']:>10.4f} {agg['gflop'] / agg['ms']:>8.1f} "
            f"{agg['bound_ms'] / agg['ms']:>8.2%} {agg['simt_ms']:>9.4f} {agg['library_ms']:>9.4f} "
            f"{agg['bound_ms']:>9.5f}")
    tc = by_variant.get("tc", dict.fromkeys(keys, 0.0))
    log(f"conv3x3 per UNet forward ({len(shapes)} calls): kernel {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, cuDNN {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms, "
        f"{tot['gflop']:.1f} GFLOP -> {tot['gflop'] / tot['ms']:.1f} TFLOP/s"
        + (f"; at the {tc.get('calls', 0)} tc shapes: tc {tc['ms']:.3f} ms against simt "
           f"{tc['simt_ms']:.3f} ms" if extras else ""))
    if extras and not tc["ms"] * 5 <= tc["simt_ms"]:
        raise AssertionError("conv3x3: tc takes more than 1/5 of the simt design's time per forward")
    if extras:
        fp32_summary("conv3x3 per UNet forward", tot32)
        tot["fp32"] = dict(tot32, max_abs=max_abs32)
        check_split_operand_follows_weight(gen)
    return tot, max_abs, by_variant


def check_split_operand_follows_weight(gen):
    """`tf32x3` keeps its split copy of a weight on the weight, keyed by the
    weight's version: after a step of `torch.optim.Adam` (in-place updates,
    as the trainer's and the adapted sampler's) the forward and the input
    gradient must use the new weight, within `TOL["float32"]` of the plain
    version on it, and differ from before the step."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    x, wt, bias = conv_inputs((2, 16, 16, 128), 128, "float32", gen)
    g = torch.randn((2, 16, 16, 128), generator=gen, device="cuda")
    w = torch.nn.Parameter(wt)
    opt = torch.optim.Adam([w], lr=1e-2)
    with torch.no_grad():
        before = (C.conv3x3(x, w, bias), C.conv3x3_input_grad(g, w))
    w.grad = torch.randn(w.shape, generator=gen, device="cuda")
    opt.step()
    with torch.no_grad():
        after = (C.conv3x3(x, w, bias), C.conv3x3_input_grad(g, w))
        plain = (C.conv3x3_reference(x, w, bias), C.conv3x3_input_grad(g, w, use_kernel=False))
    torch.cuda.synchronize()
    errs = [rel_err(a, p)[1] for a, p in zip(after, plain)]
    if not (all(r <= TOL["float32"] for r in errs)
            and not any(torch.equal(a, b) for a, b in zip(after, before))):
        raise AssertionError(f"conv3x3 tf32x3 after an Adam step: rel err {errs} against the plain "
                             "version on the updated weight, or the output did not change")
    log(f"conv3x3 tf32x3 after an Adam step of its weight: forward and input grad within "
        f"{max(errs):.2e} of the plain version on the updated weight (the split copy rebuilt)")


# functions whose SASS must hold HMMA (mma.sync): the attention forward, both
# kernels of its backward, the same three of the fp32 attention (`tf32x3`),
# the same six past d = 128 (attention_wide_mma.cu, attention_wide_tf32x3.cu)
# and the fp32 weight gradient's `tf32x3`; and HGMMA (wgmma) and UTMALDG (TMA
# load): the weight gradient's tensor-core kernel and the fp32 forward's
# `tf32x3`
HMMA_FUNCTIONS = ("attention_mma_kernel", "attention_bwd_mma_dq_kernel",
                  "attention_bwd_mma_dkdv_kernel", "attention_tf32x3_kernel",
                  "attention_bwd_tf32x3_dq_kernel", "attention_bwd_tf32x3_dkdv_kernel",
                  "attention_mma_wide_kernel", "attention_bwd_mma_wide_dq_kernel",
                  "attention_bwd_mma_wide_dkdv_kernel", "attention_tf32x3_wide_kernel",
                  "attention_bwd_tf32x3_wide_dq_kernel", "attention_bwd_tf32x3_wide_dkdv_kernel",
                  "wgrad_tf32x3_kernel")
HGMMA_FUNCTIONS = ("wgrad_tc_kernel", "conv3x3_tf32x3_kernel")


def sass_counts(lib_path):
    """HGMMA and UTMALDG instructions in the built library's SASS; HMMA in
    the functions named in `HMMA_FUNCTIONS`, and HGMMA and UTMALDG in those
    named in `HGMMA_FUNCTIONS`, by name."""
    import shutil

    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
             shutil.which("cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((c for c in cands if c and os.path.exists(c)), None)
    if tool is None:
        raise RuntimeError("cuobjdump not found under CUDA_HOME, on PATH or in triton's package")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    counts["HMMA"], function = dict.fromkeys(HMMA_FUNCTIONS, 0), ""
    counts["by_function"] = {name: {"HGMMA": 0, "UTMALDG": 0} for name in HGMMA_FUNCTIONS}
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1]
            continue
        for name in HMMA_FUNCTIONS:
            if name in function:
                counts["HMMA"][name] += line.count("HMMA")
        for name in HGMMA_FUNCTIONS:
            if name in function:
                for op in ("HGMMA", "UTMALDG"):
                    counts["by_function"][name][op] += line.count(op)
    return counts


def sdpa_backends():
    """(name, backend) of each SDPA backend this torch names."""
    from torch.nn.attention import SDPBackend

    names = (("flash", "FLASH_ATTENTION"), ("efficient", "EFFICIENT_ATTENTION"),
             ("cudnn", "CUDNN_ATTENTION"), ("math", "MATH"))
    return [(name, getattr(SDPBackend, attr)) for name, attr in names if hasattr(SDPBackend, attr)]


def time_sdpa(q4, k4, v4, reps):
    """Device ms of `F.scaled_dot_product_attention` on (1, B·heads, T, d)
    views, as dispatched by default and under each backend alone; a backend
    that refuses the inputs (or the graph capture) maps to its error."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    times = {"default": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)}
    for name, backend in sdpa_backends():
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q4, k4, v4)
        try:
            call()
            times[name] = time_ms(call, reps)
        except RuntimeError as err:
            times[name] = str(err).splitlines()[0][:100]
    return times


def check_attention_once(shape, dt, gen):
    """One kernel call against the plain version; for mma and tf32x3 also a
    second call, which must give the same bits, and a call that saves the
    rows' log-sum-exp: the same output bit for bit, and lse2 against the
    plain `attention_lse_reference`; for tf32x3 also the forced `simt`
    kernel it replaced (the yardstick of its speed gate) against the plain
    version.  Returns (inputs, plan, max|diff|, rel)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    tdt = getattr(torch, dt)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(tdt) for _ in range(3))
    p = A.plan(*shape, tdt)
    out = A.attention(q, k, v)
    ref = A.attention(q, k, v, use_kernel=False)
    torch.cuda.synchronize()
    d, r = rel_err(out, ref)
    if not (torch.isfinite(out).all() and r <= TOL[dt]):
        raise AssertionError(f"attention {p.variant} {shape} {dt}: rel err {r:.3e} > {TOL[dt]}")
    if p.variant in ("mma", "tf32x3"):
        if not torch.equal(out, A.attention(q, k, v)):
            raise AssertionError(f"attention {p.variant} {shape}: two launches differ")
        out_l, lse = A.attention_with_lse(q, k, v)
        _, r_lse = rel_err(lse, A.attention_lse_reference(q, k))
        if not (torch.equal(out_l, out) and r_lse <= TOL["float32"]):
            raise AssertionError(f"attention {p.variant} {shape}: the output differs with lse on, "
                                 f"or lse2 is {r_lse:.3e} of max|plain| away (tol {TOL['float32']})")
    if p.variant == "tf32x3":
        _, r_simt = rel_err(A.attention(q, k, v, variant="simt"), ref)
        if not r_simt <= TOL[dt]:
            raise AssertionError(f"attention forced simt {shape}: rel err {r_simt:.3e} > {TOL[dt]}")
    return (q, k, v), p, d, r


def check_attention(shapes, gen, extras=True):
    """Kernel vs plain at the path's attention shapes, timed beside the plain
    version, the CUDA-core `simt` kernel, SDPA as dispatched by default and
    each SDPA backend; and at added shapes, checked only.  Returns
    per-forward totals.  Without `extras` (another model's shapes) neither
    the added shapes nor the speed gates, which hold the flagship's path."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    # checked only, each with the plan's own key splits.  mma: ragged T over
    # 4 splits (T = 300), a last round with fewer tiles than splits (T = 257),
    # d = 40 and 128, T = 1024 (4 rounds of 4 splits), d = 20 (scalar loads),
    # d = 128 over several rounds of 2 splits (T = 300); tf32x3: the fp32
    # shapes; simt: d = 256 in both dtypes
    extra = [((8, 300, 64), "bfloat16"), ((2, 257, 40), "bfloat16"),
             ((3, 100, 128), "bfloat16"), ((8, 1024, 64), "bfloat16"),
             ((2, 37, 20), "bfloat16"), ((3, 300, 128), "bfloat16"),
             ((2, 257, 40), "float32"), ((3, 100, 128), "float32"),
             ((8, 256, 64), "float32"), ((1, 5, 8), "float32"),
             ((2, 64, 256), "float32"), ((2, 64, 256), "bfloat16")] if extras else []
    # and the rest of tf32x3's: the path's fp32 shapes at batch 1 and at the
    # training batch (one stage), ragged T over 4 splits, T = 1024, d = 20 and
    # 128 over several rounds, T = 1, d = 18 and 13 (scalar loads; d = 13
    # scalar stores).  Their inputs come from a generator of their own, so
    # that every other check of the run keeps the draws it had before them.
    added = [((8, 64, 64), "float32"), ((8 * TRAIN_BATCH, 256, 64), "float32"),
             ((8 * TRAIN_BATCH, 64, 64), "float32"), ((8, 300, 64), "float32"),
             ((8, 1024, 64), "float32"), ((2, 37, 20), "float32"), ((3, 300, 128), "float32"),
             ((1, 1, 16), "float32"), ((2, 37, 18), "float32"),
             ((3, 100, 13), "float32")] if extras else []
    own = torch.Generator(device="cuda").manual_seed(18)
    keys = ("ms", "plain_ms", "library_ms", "library_best_ms", "bound_ms", "ops_ms", "bytes_ms",
            "simt_ms", "lse_ms")
    tot = dict.fromkeys(keys, 0.0)
    best_names = set()
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs = 0.0
    log(f"{'attention (BH,T,d)':>28} {'dtype':>8} {'n':>3} {'variant':>7} {'w/s':>5} "
        f"{'kernel_ms':>10} {'simt_ms':>9} {'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} "
        f"{'bound_by':>10} {'rel_err':>9}")
    for (shape, dt), g in [(c, gen) for c in list(counts) + extra] + [(c, own) for c in added]:
        n = counts.get((shape, dt), 0)
        (q, k, v), p, d, r = check_attention_once(shape, dt, g)
        worst[dt] = max(worst[dt], r)
        blocking = f"{p.warps}/{p.key_splits}"
        if n == 0:
            log(f"{str(shape):>28} {dt:>8} {'-':>3} {p.variant:>7} {blocking:>5} {'':>10} {'':>9} "
                f"{'':>9} {'':>10} {'':>9} {'':>10} {r:>9.2e}")
            continue
        max_abs = max(max_abs, d)
        bh, t, dd = shape
        # lse off and on in turns: off, on, on, off
        off = [time_ms(lambda: A.attention(q, k, v), 100)]
        on = [time_ms(lambda: A.attention_with_lse(q, k, v), 100) for _ in range(2)]
        off.append(time_ms(lambda: A.attention(q, k, v), 100))
        k_ms, lse_ms = sum(off) / 2, sum(on) / 2
        s_ms = time_ms(lambda: A.attention(q, k, v, variant="simt"), 100)
        p_ms = time_ms(lambda: A.attention(q, k, v, use_kernel=False), 50)
        sdpa = time_sdpa(*(a.view(1, bh, t, dd) for a in (q, k, v)), 100)
        taken = {name: ms for name, ms in sdpa.items() if name != "default" and isinstance(ms, float)}
        best = min(taken, key=taken.get)
        best_names.add(best)
        flops = 4.0 * bh * t * t * dd
        nbytes = 4.0 * q.numel() * q.element_size()
        b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
        log(f"{str(shape):>28} {dt:>8} {n:>3} {p.variant:>7} {blocking:>5} {k_ms:>10.4f} "
            f"{s_ms:>9.4f} {p_ms:>9.4f} {sdpa['default']:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
        log(f"{'':>28} SDPA on (1, B·heads, T, d): "
            + ", ".join(f"{name} {ms:.4f} ms" if isinstance(ms, float) else f"{name} refused ({ms})"
                        for name, ms in sdpa.items()))
        log(f"{'':>28} with the saved log-sum-exp: {lse_ms:.4f} ms ({lse_ms / k_ms - 1:+.2%})")
        row = dict(ms=k_ms, plain_ms=p_ms, library_ms=sdpa["default"], library_best_ms=taken[best],
                   bound_ms=b_ms, ops_ms=ops_ms, bytes_ms=bytes_ms, simt_ms=s_ms, lse_ms=lse_ms)
        for key in keys:
            tot[key] += n * row[key]
    log(f"attention max rel err: bf16 {worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), "
        f"fp32 {worst['float32']:.3e} (tol {TOL['float32']}); mma and tf32x3 bitwise equal over "
        f"two launches and with their log-sum-exp saved")
    tot["library_best"] = "/".join(sorted(best_names))
    log(f"attention per UNet forward ({len(shapes)} calls): kernel {tot['ms']:.4f} ms, simt "
        f"{tot['simt_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, SDPA default "
        f"{tot['library_ms']:.4f} ms, fastest SDPA backend ({tot['library_best']}) "
        f"{tot['library_best_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
    log(f"attention: mma per forward takes {tot['ms'] / tot['library_ms']:.3f}x the time of SDPA as "
        f"dispatched by default, {tot['ms'] / tot['library_best_ms']:.3f}x its fastest backend, "
        f"{tot['ms'] / tot['simt_ms']:.3f}x the simt kernel; with the log-sum-exp saved "
        f"{tot['lse_ms']:.4f} ms ({tot['lse_ms'] / tot['ms'] - 1:+.2%}, at most +5%)")
    if not extras:
        return tot, max_abs
    if not (tot["ms"] <= tot["plain_ms"] and tot["ms"] <= tot["library_ms"]
            and tot["ms"] < tot["simt_ms"]):
        raise AssertionError("attention: mma is slower per forward than its plain version, "
                             "than SDPA as dispatched by default or than the simt kernel")
    if not tot["lse_ms"] <= 1.05 * tot["ms"]:
        raise AssertionError("attention: saving the log-sum-exp costs mma more than 5% per forward")
    return tot, max_abs

def check_conv_backward(shapes, gen):
    """The conv3x3 input gradient (`conv3x3_input_grad`, the launch function
    itself) at every distinct conv shape in both I/O types against autograd
    of the plain version, bitwise equal over two launches and equal to the
    autograd Function's; the Function's bias gradient against autograd's.
    Timed in the path's type beside the plain twin, cuDNN's `conv2d_input`
    and the bound, summed over the convs whose input takes a gradient in the
    adapted and training backwards (all but the stem, whose input is the
    diffusion state); the stem's (`narrow`, DPS's gradient in x) apart.
    In fp32 at the shapes whose swapped conv `tf32x3` takes, the fp32 route
    (`fp32_row`: forced `simt` on the swapped weight, cuDNN fp32), its total
    per backward in `tot["fp32"]`, gated at half of forced `simt`'s.
    Returns (per-backward totals, max|diff|, launches by variant per
    backward, the stem's row)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    tot = dict.fromkeys(keys, 0.0)
    stem = None
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs, by_variant = 0.0, {}
    tot32, max_abs32 = dict.fromkeys(FP32_KEYS, 0.0), 0.0
    tot32["calls"] = 0
    log(f"{'input grad (B,H,W,Cin<-Cout)':>28} {'dtype':>8} {'n':>3} {'variant':>7} {'splits':>6} "
        f"{'kernel_ms':>10} {'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} {'bound_by':>10} "
        f"{'rel_err':>9} {'bias_err':>9}")
    for (xshape, cout, dtype), n in sorted(counts.items(), key=lambda kv: (-kv[0][0][1], kv[0][0][3])):
        b, h, w, cin = xshape
        needs = cin != 1                 # the stem's input takes no gradient
        for dt in ("bfloat16", "float32"):
            x, wt, bias = conv_inputs(xshape, cout, dt, gen)
            g = torch.randn((b, h, w, cout), generator=gen, device="cuda").to(x.dtype)
            gx = C.conv3x3_input_grad(g, wt)
            again = C.conv3x3_input_grad(g, wt)
            xr, br = x.clone().requires_grad_(), bias.clone().requires_grad_()
            rx, rb = torch.autograd.grad(C.conv3x3_reference(xr, wt, br), (xr, br), g)
            xk, bk = x.clone().requires_grad_(), bias.clone().requires_grad_()
            kx, kb = torch.autograd.grad(C.conv3x3(xk, wt, bk), (xk, bk), g)
            torch.cuda.synchronize()
            d, r = rel_err(gx, rx)
            _, rb_err = rel_err(kb, rb)
            p = C.plan(b, h, w, cout, cin, x.dtype)
            label = f"{str((b, h, w, cin)) + '<-' + str(cout):>28} {dt:>8}"
            if not (torch.isfinite(gx).all() and r <= TOL[dt] and rb_err <= TOL["float32"]):
                raise AssertionError(f"conv3x3 input grad {label}: rel err {r:.3e}, bias {rb_err:.3e}")
            if not (torch.equal(gx, again) and torch.equal(kx, gx)):
                raise AssertionError(f"conv3x3 input grad {label}: launches or the Function differ")
            worst[dt] = max(worst[dt], r)
            if dt == "float32" and p.variant == "tf32x3":
                max_abs32 = max(max_abs32, d)
                sw, zero = C.swapped_weight(wt), torch.zeros(cin, device="cuda")
                gl = g.permute(0, 3, 1, 2)
                wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                row = fp32_row(
                    label, n, lambda: C.conv3x3_input_grad(g, wt),
                    lambda: C.conv3x3(g, sw, zero, variant="simt"),
                    lambda: C.conv3x3_input_grad(g, wt, use_kernel=False),
                    lambda: torch.nn.grad.conv2d_input((b, cin, h, w), wl, gl, padding=1),
                    2.0 * b * h * w * cin * cout * 9, 4.0 * (g.numel() * (1 + cin / cout) + wt.numel()),
                    10 if h >= 128 else 30)
                for key in FP32_KEYS:
                    tot32[key] += n * row[key]
                tot32["calls"] += n
            if dt != dtype:
                log(f"{label} {'-':>3} {p.variant:>7} {p.splits:>6} {'':>10} {'':>9} {'':>10} {'':>9} "
                    f"{'':>10} {r:>9.2e} {rb_err:>9.2e}")
                continue
            max_abs = max(max_abs, d)
            gl = g.permute(0, 3, 1, 2)                             # channels-last NCHW views
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            size = (b, cin, h, w)
            reps = 20 if h >= 128 else 50
            k_ms = time_ms(lambda: C.conv3x3_input_grad(g, wt), reps)
            p_ms = time_ms(lambda: C.conv3x3_input_grad(g, wt, use_kernel=False), max(reps // 4, 5))
            l_ms = time_ms(lambda: torch.nn.grad.conv2d_input(size, wl, gl, padding=1), reps)
            flops = 2.0 * b * h * w * cin * cout * 9
            nbytes = g.numel() * g.element_size() * (1 + cin / cout) + wt.numel() * wt.element_size()
            b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
            log(f"{label} {n:>3} {p.variant:>7} {p.splits:>6} {k_ms:>10.4f} {p_ms:>9.4f} "
                f"{l_ms:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e} {rb_err:>9.2e}"
                + ("" if needs else "  (the stem: only DPS's gradient in x takes it)"))
            row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, ops_ms=ops_ms,
                       bytes_ms=bytes_ms)
            if not needs:
                stem = dict(row, variant=p.variant)
                continue
            by_variant[p.variant] = by_variant.get(p.variant, 0) + n
            for key in keys:
                tot[key] += n * row[key]
    log(f"conv3x3 input grad max rel err: bf16 {worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), "
        f"fp32 {worst['float32']:.3e} (tol {TOL['float32']}); bitwise equal over two launches")
    log(f"conv3x3 input grad per UNet backward ({sum(by_variant.values())} calls: "
        + ", ".join(f"{v} {k}" for v, k in by_variant.items())
        + f"): kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, cuDNN conv2d_input "
        f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms; the stem's ({stem['variant']}, "
        f"DPS only) {stem['ms']:.4f} ms, plain {stem['plain_ms']:.4f}, cuDNN {stem['library_ms']:.4f}, "
        f"bound {stem['bound_ms']:.5f}")
    fp32_summary("conv3x3 input grad per UNet backward", tot32)
    tot["fp32"] = dict(tot32, max_abs=max_abs32)
    return tot, max_abs, by_variant, stem


def check_conv_bias(shapes, gen):
    """Phase 11a: the forward kernels with a bias per image ((B, Cout), the
    batched adapted path's) at every conv shape of a batch-4 forward, in
    both I/O types, against `conv3x3_reference` within `TOL`: `tc` as
    planned and with its split of K forced to one and to several splits
    (the one-split epilogue and the split-K reduction), `tf32x3` the same
    in fp32, `narrow` and `simt` as planned, and `simt` also at the `tc` and
    `tf32x3` shapes; with four equal rows
    each launch bitwise equal to the shared-bias launch; the per-image bias
    gradient through the autograd Function against autograd of the plain
    version.  Timed in the path's type beside the plain version, cuDNN
    (`F.conv2d` with a shared bias: it takes no bias per image) and the
    bound.  Returns (per-forward totals, max|diff|, launches by variant per
    forward)."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms", "gflop")
    tot = dict.fromkeys(keys, 0.0)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs, by_variant, checked = 0.0, {}, 0
    log(f"{'per-image bias (B,H,W,Cin->Cout)':>32} {'dtype':>8} {'n':>3} {'variant':>7} "
        f"{'splits':>6} {'kernel_ms':>10} {'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} "
        f"{'rel_err':>9} {'bias_err':>9}")
    for (xshape, cout, dtype), n in sorted(counts.items(), key=lambda kv: (-kv[0][0][1], kv[0][0][3])):
        b, h, w, cin = xshape
        for dt in ("bfloat16", "float32"):
            x, wt, _ = conv_inputs(xshape, cout, dt, gen)
            bias = torch.randn((b, cout), generator=gen, device="cuda") * 0.1
            p = C.plan(b, h, w, cin, cout, x.dtype)
            runs = [(p.variant, None)]
            if p.variant in ("tc", "tf32x3"):   # both epilogues: one split and the split-K reduction
                runs += [(p.variant, 1 if p.splits > 1 else 2), ("simt", None)]
            ref = C.conv3x3_reference(x, wt, bias)
            same = bias[:1].expand(b, cout).contiguous()     # four equal rows
            shared = bias[0].contiguous()
            for variant, splits in runs:
                out = C.conv3x3(x, wt, bias, variant=variant, splits=splits)
                eq = C.conv3x3(x, wt, same, variant=variant, splits=splits)
                one = C.conv3x3(x, wt, shared, variant=variant, splits=splits)
                torch.cuda.synchronize()
                d, r = rel_err(out, ref)
                label = (f"{str((b, h, w, cin)) + '->' + str(cout):>32} {dt:>8} {variant}"
                         f"{'' if splits is None else f' splits={splits}'}")
                if not (torch.isfinite(out).all() and r <= TOL[dt]):
                    raise AssertionError(f"conv3x3 per-image bias {label}: rel err {r:.3e} > {TOL[dt]}")
                if not torch.equal(eq, one):
                    raise AssertionError(f"conv3x3 per-image bias {label}: four equal rows differ "
                                         "from the shared-bias launch")
                worst[dt] = max(worst[dt], r)
                checked += 1
            # the bias gradient per image, through the autograd Function
            g = torch.randn((b, h, w, cout), generator=gen, device="cuda").to(x.dtype)
            bk, br = bias.clone().requires_grad_(), bias.clone().requires_grad_()
            (kb,) = torch.autograd.grad(C.conv3x3(x, wt, bk), (bk,), g)
            (rb,) = torch.autograd.grad(C.conv3x3_reference(x, wt, br), (br,), g)
            _, rb_err = rel_err(kb, rb)
            if not (kb.shape == (b, cout) and rb_err <= TOL["float32"]):
                raise AssertionError(f"conv3x3 per-image bias gradient {xshape}->{cout} {dt}: "
                                     f"rel err {rb_err:.3e}")
            if dt != dtype:
                continue
            out = C.conv3x3(x, wt, bias)
            max_abs = max(max_abs, rel_err(out, ref)[0])
            xl = x.permute(0, 3, 1, 2)
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bl = bias[0].to(x.dtype)
            reps = 10 if h >= 128 else 40
            k_ms = time_ms(lambda: C.conv3x3(x, wt, bias), reps)
            p_ms = time_ms(lambda: C.conv3x3(x, wt, bias, use_kernel=False), max(reps // 4, 3))
            l_ms = time_ms(lambda: F.conv2d(xl, wl, bl, padding=1), reps)
            flops = 2.0 * b * h * w * cin * cout * 9
            nbytes = (x.numel() * x.element_size() * (1 + cout / cin) + wt.numel() * wt.element_size()
                      + 4 * bias.numel())
            b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
            log(f"{str((b, h, w, cin)) + '->' + str(cout):>32} {dt:>8} {n:>3} {p.variant:>7} "
                f"{p.splits:>6} {k_ms:>10.4f} {p_ms:>9.4f} {l_ms:>10.4f} {b_ms:>9.5f} "
                f"{rel_err(out, ref)[1]:>9.2e} {rb_err:>9.2e}")
            by_variant[p.variant] = by_variant.get(p.variant, 0) + n
            row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, ops_ms=ops_ms,
                       bytes_ms=bytes_ms, gflop=flops / 1e9)
            for key in keys:
                tot[key] += n * row[key]
    log(f"conv3x3 with a bias per image: {checked} launches checked, max rel err bf16 "
        f"{worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), fp32 {worst['float32']:.3e} (tol "
        f"{TOL['float32']}); four equal rows bitwise equal to the shared-bias launch in every "
        "variant; the bias gradient per image within the fp32 tolerance")
    log(f"conv3x3 per batch-{shapes[0][0][0]} UNet forward with a bias per image "
        f"({sum(by_variant.values())} calls: " + ", ".join(f"{v} {k}" for v, k in by_variant.items())
        + f"): kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, cuDNN (shared bias) "
        f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms, {tot['gflop']:.1f} GFLOP -> "
        f"{tot['gflop'] / tot['ms']:.1f} TFLOP/s, {tot['bound_ms'] / tot['ms']:.1%} of the bound")
    return tot, max_abs, by_variant


def wgrad_reduce_ms(p, cin, cout, reps):
    """Device ms of the weight gradient's split-K reduction alone, for plan
    `p` (0 where no partial sums reach device memory)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import _build

    groups = p.splits // p.cluster
    if groups < 2:
        return 0.0
    n = 9 * cin * cout
    ws, dw = torch.randn(groups * n, device="cuda"), torch.empty(n, device="cuda")
    lib = _build.library()

    def call():
        rc = lib.conv3x3_wgrad_reduce(ws.data_ptr(), dw.data_ptr(), n, groups,
                                      torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "conv3x3 weight grad reduction")
    return time_ms(call, reps)


def check_conv_wgrad(shapes, gen):
    """The conv3x3 weight gradient (`conv3x3_weight_grad`, the launch
    function) at every conv shape of a batch-3 training forward and of a
    batch-1 forward (`shapes`: the batch-1 calls), in both I/O types,
    against `conv3x3_weight_grad_reference` on the same inputs, bitwise
    equal over two launches; at added shapes (H != W, ragged boxes, 64, 192
    and 384 input channels, an 8² map at batch 1, the largest split, the
    narrow kernels with a few small channels, `mma`) checked only.  Timed in
    the path's type per UNet backward beside the plain twin, cuDNN's
    `conv2d_weight` (channels-last) and the bound, with the split-K
    reduction's share timed alone; at batch 3 the narrow kernels must be
    no slower than cuDNN on the same shapes (`tc`'s ratio is printed), and
    every `tc` grid must fit one wave of the card's clusters.  Returns
    ({batch: per-backward totals, (batch, variant): the same}, max|diff|,
    {batch: launches by variant per backward})."""
    import ctypes

    import torch

    from diffusion_models_dev_project_tpu_torch.ops import _build
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms", "reduce_ms",
            "partial_bytes")
    tots, by_batch = {}, {}
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs = 0.0
    sms = C.device_sms(torch.device("cuda"))
    lib = _build.library()
    max_clusters = {}
    for c in (1, 2):
        n = ctypes.c_int(0)
        _build.check(lib.conv3x3_wgrad_tc_max_clusters(c, ctypes.byref(n)), "max active clusters")
        max_clusters[c] = n.value
    log(f"  weight grad: {sms} SMs; tc clusters of 1, 2 blocks at once: "
        + ", ".join(str(v) for v in max_clusters.values()))
    log(f"{'weight grad (B,H,W,Cin->Cout)':>30} {'dtype':>8} {'n':>3} {'variant':>10} {'splits':>9} "
        f"{'kernel_ms':>10} {'reduce_ms':>9} {'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} "
        f"{'bound_by':>10} {'rel_err':>9}")

    def check_once(xshape, cout, dt, splits=None):
        b, h, w, cin = xshape
        tdt = getattr(torch, dt)
        x = torch.randn(xshape, generator=gen, device="cuda").to(tdt)
        g = (0.1 * torch.randn((b, h, w, cout), generator=gen, device="cuda")).to(tdt)
        p = C.wgrad_plan(b, h, w, cin, cout, tdt, None, splits, sms)
        dw = C.conv3x3_weight_grad(x, g, splits=splits)
        again = C.conv3x3_weight_grad(x, g, splits=splits)
        ref = C.conv3x3_weight_grad_reference(x, g)
        torch.cuda.synchronize()
        d, r = rel_err(dw, ref)
        if not (dw.dtype == torch.float32 and torch.isfinite(dw).all() and r <= TOL_WGRAD):
            raise AssertionError(f"conv3x3 weight grad {xshape}->{cout} {dt} ({p.variant}, "
                                 f"{p.splits} splits): rel err {r:.3e} > {TOL_WGRAD}")
        if not torch.equal(dw, again):
            raise AssertionError(f"conv3x3 weight grad {xshape}->{cout} {dt}: two launches differ")
        if p.variant == "tc" and p.tiles * p.splits > max_clusters[p.cluster] * p.cluster:
            raise AssertionError(f"conv3x3 weight grad {xshape}->{cout}: {p.tiles} x {p.splits} "
                                 f"blocks in clusters of {p.cluster} exceed one wave")
        worst[dt] = max(worst[dt], r)
        return x, g, p, d, r

    def split_text(p):
        return f"{p.splits}/{p.cluster}" if p.variant == "tc" else str(p.splits)

    fp32 = {"max_abs": 0.0}
    for batch in (TRAIN_BATCH, 1):
        counts = {}
        for xs, cout, dt in shapes:
            key = ((batch,) + tuple(xs[1:]), cout, dt)
            counts[key] = counts.get(key, 0) + 1
        tot, variants = dict.fromkeys(keys, 0.0), {}
        tot32 = fp32[batch] = dict(dict.fromkeys(FP32_KEYS, 0.0), calls=0)
        for (xshape, cout, dtype), n in sorted(counts.items(), key=lambda kv: (-kv[0][0][1], kv[0][0][3])):
            b, h, w, cin = xshape
            for dt in ("bfloat16", "float32"):
                x, g, p, d, r = check_once(xshape, cout, dt)
                label = f"{str(xshape) + '->' + str(cout):>30} {dt:>8}"
                if dt == "float32" and p.variant == "tf32x3":
                    fp32["max_abs"] = max(fp32["max_abs"], d)
                    xl, gl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
                    row = fp32_row(
                        label, n, lambda: C.conv3x3_weight_grad(x, g),
                        lambda: C.conv3x3_weight_grad(x, g, variant="simt"),
                        lambda: C.conv3x3_weight_grad(x, g, use_kernel=False),
                        lambda: torch.nn.grad.conv2d_weight(xl, (cout, cin, 3, 3), gl, padding=1),
                        2.0 * b * h * w * cin * cout * 9,
                        4.0 * (x.numel() + g.numel() + 9 * cin * cout), 5 if b * h * w >= 65536 else 20)
                    for key in FP32_KEYS:
                        tot32[key] += n * row[key]
                    tot32["calls"] += n
                if dt != dtype:
                    log(f"{label} {'-':>3} {p.variant:>10} {split_text(p):>9} {'':>10} {'':>9} {'':>9} "
                        f"{'':>10} {'':>9} {'':>10} {r:>9.2e}")
                    continue
                max_abs = max(max_abs, d)
                variants[p.variant] = variants.get(p.variant, 0) + n
                xl, gl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)    # channels-last NCHW views
                size = (cout, cin, 3, 3)
                reps = 5 if b * h * w >= 65536 else 20
                k_ms = time_ms(lambda: C.conv3x3_weight_grad(x, g), reps)
                r_ms = wgrad_reduce_ms(p, cin, cout, reps)
                p_ms = time_ms(lambda: C.conv3x3_weight_grad(x, g, use_kernel=False), max(reps // 4, 2))
                l_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(xl, size, gl, padding=1), reps)
                flops = 2.0 * b * h * w * cin * cout * 9
                nbytes = x.numel() * x.element_size() + g.numel() * g.element_size() + 4 * 9 * cin * cout
                b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
                log(f"{label} {n:>3} {p.variant:>10} {split_text(p):>9} {k_ms:>10.4f} {r_ms:>9.4f} "
                    f"{p_ms:>9.4f} {l_ms:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
                row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, ops_ms=ops_ms,
                           bytes_ms=bytes_ms, reduce_ms=r_ms, partial_bytes=p.workspace_bytes)
                for agg in (tot, tots.setdefault((batch, p.variant), dict.fromkeys(keys, 0.0))):
                    for key in keys:
                        agg[key] += n * row[key]
        tots[batch], by_batch[batch] = tot, variants
        fp32_summary(f"conv3x3 weight grad per batch-{batch} UNet backward", tot32,
                     gate=batch == TRAIN_BATCH)
        log(f"conv3x3 weight grad per batch-{batch} UNet backward ({sum(variants.values())} calls: "
            + ", ".join(f"{v} {k}" for v, k in variants.items())
            + f"): kernel {tot['ms']:.3f} ms (of it the split-K reduction alone {tot['reduce_ms']:.3f} "
            f"ms; the plans' workspaces hold {tot['partial_bytes'] / 1e9:.3f} GB of partial sums), plain "
            f"{tot['plain_ms']:.3f} ms, cuDNN conv2d_weight {tot['library_ms']:.3f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['ms'] and tot['bound_ms'] / tot['ms']:.1%} of it)")
        for v in C.WGRAD_VARIANTS:
            t = tots.get((batch, v))
            if t is not None:
                log(f"  {v} per batch-{batch} backward ({variants[v]} calls): kernel {t['ms']:.4f} ms "
                    f"(reduction {t['reduce_ms']:.4f}), cuDNN {t['library_ms']:.4f} ms "
                    f"({t['ms'] / t['library_ms']:.3f}x), bound {t['bound_ms']:.5f} ms")
    # the speed comparisons, per batch-3 backward: tc, and the stem's and
    # final conv's narrow kernels together, each against cuDNN on the same
    # shapes; the narrow kernels are gated, tc's ratio is printed (it misses
    # cuDNN: PERF.md §6)
    zero = dict.fromkeys(keys, 0.0)
    tc3 = tots.get((TRAIN_BATCH, "tc"), zero)
    narrow = {bt: {k: tots.get((bt, "narrow_out"), zero)[k] + tots.get((bt, "narrow_in"), zero)[k]
                   for k in keys} for bt in (TRAIN_BATCH, 1)}
    tc1 = tots.get((1, "tc"), zero)
    tc_ratio = tc3["ms"] / tc3["library_ms"]
    log(f"conv3x3 weight grad against cuDNN, per batch-{TRAIN_BATCH} backward: tc {tc3['ms']:.4f} ms vs "
        f"cuDNN {tc3['library_ms']:.4f} ms ({tc_ratio:.3f}x; not gated: "
        f"{'no slower' if tc_ratio <= 1 else 'SLOWER'} than cuDNN); stem + final conv "
        f"{narrow[TRAIN_BATCH]['ms']:.4f} ms vs cuDNN {narrow[TRAIN_BATCH]['library_ms']:.4f} ms (gate: no "
        f"slower).  Batch 1 (not gated): tc {tc1['ms']:.4f} vs {tc1['library_ms']:.4f} ms "
        f"({tc1['library_ms'] and tc1['ms'] / tc1['library_ms']:.3f}x), stem + final "
        f"{narrow[1]['ms']:.4f} vs {narrow[1]['library_ms']:.4f} ms "
        f"({narrow[1]['library_ms'] and narrow[1]['ms'] / narrow[1]['library_ms']:.3f}x)")
    if not narrow[TRAIN_BATCH]["ms"] <= narrow[TRAIN_BATCH]["library_ms"]:
        raise AssertionError("conv3x3 weight grad: per batch-3 backward the stem's and final conv's "
                             "kernels are slower than cuDNN's conv2d_weight on those shapes")
    # checked only: H != W, ragged boxes, 64, 192 and 384 input channels, an
    # 8² map at batch 1, the largest split, narrow kernels with a few small
    # channels, the mma variant
    for xshape, cout, dt, splits in (((2, 16, 48, 128), 128, "bfloat16", None),
                                     ((1, 12, 20, 128), 128, "bfloat16", None),
                                     ((1, 32, 32, 64), 64, "bfloat16", None),
                                     ((1, 12, 20, 192), 192, "bfloat16", None),
                                     ((1, 32, 32, 384), 128, "bfloat16", None),
                                     ((1, 8, 8, 512), 512, "bfloat16", None),
                                     ((1, 64, 64, 128), 128, "bfloat16", 32),
                                     ((2, 16, 16, 128), 3, "bfloat16", None),
                                     ((2, 9, 7, 3), 20, "float32", None),
                                     ((1, 12, 20, 128), 192, "float32", None),
                                     ((1, 64, 64, 128), 128, "float32", 7),
                                     ((1, 12, 20, 48), 80, "float32", None),
                                     ((2, 16, 16, 48), 80, "bfloat16", None)):
        _, _, p, _, r = check_once(xshape, cout, dt, splits)
        log(f"{str(xshape) + '->' + str(cout):>30} {dt:>8} {'-':>3} {p.variant:>10} "
            f"{split_text(p):>9} {'':>10} {'':>9} {'':>9} {'':>10} {'':>9} {'':>10} {r:>9.2e}")
    log(f"conv3x3 weight grad max rel err: bf16 {worst['bfloat16']:.3e}, fp32 {worst['float32']:.3e} "
        f"(tol {TOL_WGRAD}); bitwise equal over two launches")
    tots["fp32"] = fp32
    return tots, max_abs, by_batch


def check_attention_backward(shapes, gen):
    """`attention_backward` (the launch function) with each variant that
    takes the shape, `mma` and `tf32x3` given the lse2 of the forward kernel
    (`attention_with_lse`), at the path's attention shapes and at added ones,
    against `attention_backward_reference`: dq, dk and dv each within the
    tolerance of max|plain|, bitwise equal over two launches.  At the path's
    shapes timed: the planned kernel, `mma` at each chunk it takes, `simt`
    (the earlier design), the plain twin, SDPA's backward (forward and backward
    captured together, less the forward) and the bound.  Returns
    (per-backward totals, max|diff|, calls by variant per backward)."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    # checked only: ragged T over several chunks a warp (T = 300, 1024, and
    # d = 128 in two stages), T = 37 with d = 20 (scalar loads), d = 40, a
    # single row or a few (T = 1, 5 at d = 8), d = 256 (simt only), fp32
    # (tf32x3 and the forced simt)
    extra = [((8, 300, 64), "bfloat16"), ((2, 37, 20), "bfloat16"), ((3, 100, 128), "bfloat16"),
             ((3, 300, 128), "bfloat16"), ((2, 257, 40), "bfloat16"), ((8, 1024, 64), "bfloat16"),
             ((1, 1, 8), "bfloat16"), ((1, 5, 8), "bfloat16"), ((2, 64, 256), "bfloat16"),
             ((8, 256, 64), "float32"), ((2, 257, 40), "float32"), ((2, 64, 256), "float32"),
             ((1, 5, 8), "float32"), ((1, 1, 16), "float32")]
    # and the rest of tf32x3's, as in `check_attention`: the path's shapes at
    # batch 1 and at the training batch, ragged T, T = 1024, d = 20 and 128
    # over several chunks, d = 18 and 13 (scalar loads), from a generator of
    # their own
    added = [((8, 64, 64), "float32"), ((8 * TRAIN_BATCH, 256, 64), "float32"),
             ((8 * TRAIN_BATCH, 64, 64), "float32"), ((8, 300, 64), "float32"),
             ((2, 37, 20), "float32"), ((3, 100, 128), "float32"), ((3, 300, 128), "float32"),
             ((8, 1024, 64), "float32"), ((2, 37, 18), "float32"), ((3, 100, 13), "float32")]
    own = torch.Generator(device="cuda").manual_seed(18)
    keys = ("ms", "simt_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    tot = dict.fromkeys(keys, 0.0)
    by_variant, by_tile = {}, {}
    worst = {(v, dt): 0.0 for v in A.VARIANTS for dt in ("bfloat16", "float32")}
    max_abs = 0.0
    log(f"{'attention bwd (BH,T,d)':>28} {'dtype':>8} {'n':>3} {'variant':>7} {'tile':>4} "
        f"{'grid':>9} {'kernel_ms':>10} {'simt_ms':>9} {'plain_ms':>9} {'library_ms':>10} "
        f"{'bound_ms':>9} {'bound_by':>10} {'rel_err':>9}")
    for (shape, dt), draw in [(c, gen) for c in list(counts) + extra] + [(c, own) for c in added]:
        n = counts.get((shape, dt), 0)
        bh, t, dd = shape
        tdt = getattr(torch, dt)
        q, k, v, g = (torch.randn(shape, generator=draw, device="cuda").to(tdt) for _ in range(4))
        o, lse = A.attention_with_lse(q, k, v)
        ref = A.attention_backward_reference(q, k, v, o, g)
        planned = A.backward_plan(bh, t, dd, tdt)
        variants = [planned.variant] + (["simt"] if planned.variant != "simt" else [])
        for variant in variants:
            bp = A.backward_plan(bh, t, dd, tdt, variant)
            grads = A.attention_backward(q, k, v, o, g, lse, variant=variant)
            again = A.attention_backward(q, k, v, o, g, lse, variant=variant)
            torch.cuda.synchronize()
            r, d = 0.0, 0.0
            for name, got, want, twice in zip("qkv", grads, ref, again):
                d_n, r_n = rel_err(got, want)
                if t == 1 and name in "qk":            # T = 1: dq and dk are 0 in exact
                    r_n = d_n                          # arithmetic, rounding noise here
                if not (torch.isfinite(got).all() and r_n <= TOL[dt] and torch.equal(got, twice)):
                    raise AssertionError(f"attention backward {variant} d{name} {shape} {dt}: rel "
                                         f"err {r_n:.3e} (tol {TOL[dt]}), or two launches differ")
                r, d = max(r, r_n), max(d, d_n)
            worst[variant, dt] = max(worst[variant, dt], r)
            tile = bp.tile if variant == "mma" else "-"
            grid = "x".join(map(str, bp.grid))
            if n == 0 or variant != planned.variant:
                log(f"{str(shape):>28} {dt:>8} {'-':>3} {variant:>7} {tile:>4} {grid:>9} "
                    f"{'':>10} {'':>9} {'':>9} {'':>10} {'':>9} {'':>10} {r:>9.2e}")
                continue
            max_abs = max(max_abs, d)
            by_variant[variant] = by_variant.get(variant, 0) + n
            k_ms = time_ms(lambda: A.attention_backward(q, k, v, o, g, lse), 50)
            tiles = {}
            if variant == "mma":
                for w in (16, 32, 64):
                    if w != bp.tile and (w <= 32 or dd <= 64):
                        tiles[w] = time_ms(lambda: A.attention_backward(q, k, v, o, g, lse, tile=w), 50)
                tiles[bp.tile] = k_ms
            s_ms = time_ms(lambda: A.attention_backward(q, k, v, o, g, variant="simt"), 50)
            p_ms = time_ms(lambda: A.attention_backward_reference(q, k, v, o, g), 20)
            q4, k4, v4 = (a.view(1, bh, t, dd).detach().requires_grad_() for a in (q, k, v))
            g4 = g.view(1, bh, t, dd)
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 50)
            sdpa_both = time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), g4), 50)
            l_ms = sdpa_both - sdpa_fwd
            # S recomputed, dP, dq, dk and dv: 2·T²·d operations each per batch·head;
            # q, k, v, out and dout read once, dq, dk and dv written once
            flops, nbytes = 10.0 * bh * t * t * dd, 8.0 * q.numel() * q.element_size()
            b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
            log(f"{str(shape):>28} {dt:>8} {n:>3} {variant:>7} {tile:>4} {grid:>9} {k_ms:>10.4f} "
                f"{s_ms:>9.4f} {p_ms:>9.4f} {l_ms:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
            if tiles:
                log(f"{'':>28} mma by chunk: " + ", ".join(
                    f"{w} rows {ms:.4f} ms" for w, ms in sorted(tiles.items())))
                for w, ms in tiles.items():
                    by_tile[w] = by_tile.get(w, 0.0) + n * ms
            row = dict(ms=k_ms, simt_ms=s_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                       ops_ms=ops_ms, bytes_ms=bytes_ms)
            for key in keys:
                tot[key] += n * row[key]
    log("attention backward max rel err: "
        + ", ".join(f"{v} {dt} {r:.3e} (tol {TOL[dt]})" for (v, dt), r in worst.items() if r)
        + "; bitwise equal over two launches")
    log(f"attention backward per UNet backward ({len(shapes)} calls: "
        + ", ".join(f"{v} {n}" for v, n in by_variant.items())
        + f"): kernel {tot['ms']:.4f} ms, simt (earlier design) {tot['simt_ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, SDPA backward by default {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.5f} ms")
    if len(by_tile) > 1:
        log("  mma per UNet backward with one chunk for every call (where it fits): "
            + ", ".join(f"{w} rows {ms:.4f} ms" for w, ms in sorted(by_tile.items())))
    log(f"attention backward: mma takes {tot['ms'] / tot['library_ms']:.3f}x the time of SDPA's "
        f"backward by default (target 1.0 or less), {tot['ms'] / tot['simt_ms']:.3f}x the simt "
        f"design's (at most 1/3), {tot['ms'] / tot['plain_ms']:.3f}x the plain twin's (below 1)")
    if not (by_variant == {"mma": len(shapes)} and 3 * tot["ms"] <= tot["simt_ms"]
            and tot["ms"] < tot["plain_ms"]):
        raise AssertionError("attention backward: the path is not all mma, or mma takes more than "
                             "a third of the simt design's time or no less than its plain twin's")
    return tot, max_abs, by_variant


def attention_fp32_pass(shapes, gen):
    """The fp32 route's attention (the CLIs' default dtype; `tf32x3`, forward
    and backward, checked in `check_attention` and `check_attention_backward`)
    per UNet pass at the path's attention shapes, at batch 1 and at the
    training batch (B·heads times `TRAIN_BATCH`): the kernel, the forced
    `simt` kernel it replaced, the plain version and SDPA in fp32 as
    dispatched by default (its backward: forward and backward captured
    together, less the forward), by graph replay, beside both bounds (three
    TF32 products at 495 TFLOP/s, or the bytes; the fp32 CUDA cores at 67).
    Each pass, forward and backward at either batch, must take at most half
    of forced `simt`'s time.  The training batch's inputs come from a
    generator of its own, so that the later phases keep their draws.
    Returns {batch: {"forward": totals, "backward": totals}}."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    keys = ("ms", "simt_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms",
            "fp32_bound_ms")
    out = {}
    for batch, draw in ((1, gen), (TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(18))):
        tot = {part: dict.fromkeys(keys + ("max_abs_err",), 0.0) for part in ("forward", "backward")}
        for bh, t, dd in shapes:
            shape = (bh * batch, t, dd)
            q, k, v, g = (torch.randn(shape, generator=draw, device="cuda") for _ in range(4))
            o, lse = A.attention_with_lse(q, k, v)
            errs = {"forward": [rel_err(o, A.attention_reference(q, k, v))],
                    "backward": [rel_err(a, b) for a, b in zip(
                        A.attention_backward(q, k, v, o, g, lse),
                        A.attention_backward_reference(q, k, v, o, g))]}
            for part, es in errs.items():
                if not max(r for _, r in es) <= TOL["float32"]:
                    raise AssertionError(f"attention {part} in fp32 {shape}: rel err "
                                         f"{max(r for _, r in es):.3e} > {TOL['float32']}")
                tot[part]["max_abs_err"] = max([tot[part]["max_abs_err"]] + [d for d, _ in es])
            q4, k4, v4 = (a.view(1, *shape).detach().requires_grad_() for a in (q, k, v))
            g4 = g.view(1, *shape)
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 50)
            sdpa_both = time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), g4), 50)
            flops = 4.0 * shape[0] * t * t * dd
            rows = {"forward": (time_ms(lambda: A.attention(q, k, v), 100),
                                time_ms(lambda: A.attention(q, k, v, variant="simt"), 50),
                                time_ms(lambda: A.attention(q, k, v, use_kernel=False), 20),
                                sdpa_fwd, flops, 16.0 * q.numel()),
                    "backward": (time_ms(lambda: A.attention_backward(q, k, v, o, g, lse), 50),
                                 time_ms(lambda: A.attention_backward(q, k, v, o, g,
                                                                      variant="simt"), 20),
                                 time_ms(lambda: A.attention_backward_reference(q, k, v, o, g), 20),
                                 sdpa_both - sdpa_fwd, 2.5 * flops, 32.0 * q.numel())}
            for part, (k_ms, s_ms, p_ms, l_ms, fl, nbytes) in rows.items():
                b_ms, _, ops_ms, bytes_ms = bound(TF32_PRODUCTS * fl, nbytes, "tf32")
                row = dict(ms=k_ms, simt_ms=s_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                           ops_ms=ops_ms, bytes_ms=bytes_ms,
                           fp32_bound_ms=bound(fl, nbytes, "float32")[0])
                for key in keys:
                    tot[part][key] += row[key]
        for part, t_ in tot.items():
            log(f"attention {part} in fp32 per UNet pass at batch {batch} ({len(shapes)} tf32x3 "
                f"calls): kernel {t_['ms']:.4f} ms, forced simt {t_['simt_ms']:.4f} ms "
                f"({t_['ms'] / t_['simt_ms']:.3f}x, at most 0.5), plain {t_['plain_ms']:.4f} ms, "
                f"SDPA fp32 by default {t_['library_ms']:.4f} ms ({t_['ms'] / t_['library_ms']:.3f}x); "
                f"bounds {t_['bound_ms']:.5f} ms ({TF32_PRODUCTS} TF32 products at 495 TFLOP/s or "
                f"the bytes), {t_['fp32_bound_ms']:.5f} ms (fp32 CUDA cores or the bytes)")
            if not 2 * t_["ms"] <= t_["simt_ms"]:
                raise AssertionError(f"attention {part} in fp32 at batch {batch}: tf32x3 takes more "
                                     "than half of the forced simt kernel's time per pass")
        out[batch] = tot
    return out


# heads past 128 (off every shipped path; a UNet config with num_head_channels
# -1 reaches them, phase 5b): `mma` (bf16) and `tf32x3` (fp32) in column
# chunks of 128, timed at every shape beside the forced `simt` kernels, the
# plain versions and SDPA.  d = 136 to 256 (the band `simt` took in one
# pass), 320 and 512; T = 64, 256 and 1024; B·heads 4 and 24; and the UNet's
# own calls at d = 256 (2 heads) and 512 (1 head) at 16² and 8²
WIDE_HEADS = ([(4, 256, d) for d in (136, 192, 256, 320, 512)]
              + [(4, 64, 512), (4, 1024, 192), (4, 1024, 512), (24, 256, 512), (24, 1024, 256)]
              + [(2, 256, 256), (2, 64, 256), (1, 256, 512), (1, 64, 512)])
# checked only: ragged T, d off the 16- and 8-wide slices (scalar loads), a
# single row, and a last chunk of a few columns
WIDE_CHECKED = [(2, 37, 300), (3, 100, 150), (1, 1, 136), (2, 300, 200), (1, 65, 129)]
# the draws phase 3 took from the run's generator before the wide heads went
# to the tensor cores: taken first, so that every later phase keeps its inputs
WIDE_SHARED_DRAWS = [((4, 256, d), dt) for d in (320, 512) for dt in ("float32", "bfloat16")]


def check_attention_wide(gen):
    """Attention past d = 128 (`WIDE_HEADS`, `WIDE_CHECKED`), fp32 and bf16:
    the planned kernels (`mma`, `tf32x3` in column chunks of 128) forward and
    backward against the plain versions within `TOL[dt]` of max|plain|,
    lse2 against `attention_lse_reference`, bitwise equal over two launches,
    exact launch counts by variant (no `simt` launch, every launch a wide
    one).  At the `WIDE_HEADS` shapes timed beside the forced `simt`
    kernels (gate: each pass at most half of their time), the plain
    versions, SDPA as dispatched by default (its backward: forward and
    backward captured together, less the forward) and both bounds (bf16:
    the tensor cores' rate and the bytes; fp32: three TF32 products at 495
    TFLOP/s, the fp32 CUDA cores at 67).  Every check runs before a failure
    is raised, all failures together.  Returns a row per timed shape."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    shared = {key: [torch.randn(key[0], generator=gen, device="cuda").to(getattr(torch, key[1]))
                    for _ in range(4)] for key in WIDE_SHARED_DRAWS}
    own = torch.Generator(device="cuda").manual_seed(19)
    rows, failures = [], []
    worst = {"bfloat16": 0.0, "float32": 0.0}
    log(f"{'attention, wide heads':>24} {'dtype':>8} {'pass':>8} {'var':>6} {'ch':>2} {'kernel_ms':>10} "
        f"{'simt_ms':>9} {'plain_ms':>9} {'sdpa_ms':>9} {'ops_ms':>9} {'bytes_ms':>9} {'fp32c_ms':>9} "
        f"{'rel_err':>9}")
    cases = [(shape, dt, True) for shape in WIDE_HEADS for dt in ("float32", "bfloat16")]
    cases += [(shape, dt, False) for shape in WIDE_CHECKED for dt in ("float32", "bfloat16")]
    for shape, dt, timed in cases:
        bh, t, dd = shape
        tdt = getattr(torch, dt)
        q, k, v, g = shared.pop((shape, dt), None) or [
            torch.randn(shape, generator=own, device="cuda").to(tdt) for _ in range(4)]
        p, bp = A.plan(bh, t, dd, tdt), A.backward_plan(bh, t, dd, tdt)
        variant = "mma" if dt == "bfloat16" else "tf32x3"
        if not (p.variant == bp.variant == variant and p.chunks == -(-p.d_pad // p.chunk_cols)
                and bp.chunks == -(-bp.d_pad // A.WIDE_CHUNK) > 1):
            failures.append(f"{shape} {dt}: plans {p}, {bp}")
            continue
        before = (dict(A.launches_by_variant), dict(A.backward_launches_by_variant),
                  A.wide_launches, A.wide_backward_launches)
        out, lse = A.attention_with_lse(q, k, v)
        out2, lse2 = A.attention_with_lse(q, k, v)
        out3 = A.attention(q, k, v)
        grads = A.attention_backward(q, k, v, out, g, lse)
        grads2 = A.attention_backward(q, k, v, out, g, lse)
        torch.cuda.synchronize()
        fwd_n = {v_: A.launches_by_variant[v_] - before[0][v_] for v_ in A.VARIANTS}
        bwd_n = {v_: A.backward_launches_by_variant[v_] - before[1][v_] for v_ in A.VARIANTS}
        wide_n = (A.wide_launches - before[2], A.wide_backward_launches - before[3])
        want_n = {v_: 3 if v_ == variant else 0 for v_ in A.VARIANTS}
        if fwd_n != want_n or bwd_n != dict(want_n, **{variant: 2}) or wide_n != (3, 2):
            failures.append(f"{shape} {dt}: launches forward {fwd_n}, backward {bwd_n}, wide {wide_n}")
        ref = A.attention(q, k, v, use_kernel=False)
        gref = A.attention_backward_reference(q, k, v, out, g)
        d_f, r_f = rel_err(out, ref)
        _, r_lse = rel_err(lse, A.attention_lse_reference(q, k))
        errs = []
        for name, a, b in zip("qkv", grads, gref):
            d_n, r_n = rel_err(a, b)
            # T = 1: dq and dk are 0 in exact arithmetic, rounding noise here
            errs.append((d_n, d_n if t == 1 and name in "qk" else r_n))
        d_b, r_b = max(e[0] for e in errs), max(e[1] for e in errs)
        worst[dt] = max(worst[dt], r_f, r_b)
        same = (torch.equal(out, out2) and torch.equal(out, out3) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        finite = all(torch.isfinite(a).all() for a in (out, lse, *grads))
        if not (finite and same and r_f <= TOL[dt] and r_b <= TOL[dt] and r_lse <= TOL["float32"]):
            failures.append(f"{shape} {dt}: rel err forward {r_f:.3e}, backward {r_b:.3e} (tol "
                            f"{TOL[dt]}), lse2 {r_lse:.3e}; finite {bool(finite)}, two launches "
                            f"{'equal' if same else 'DIFFER'}")
        if not timed:
            log(f"{str(shape):>24} {dt:>8} {'both':>8} {variant:>6} {p.chunks:>2} {'':>10} {'':>9} "
                f"{'':>9} {'':>9} {'':>9} {'':>9} {'':>9} {max(r_f, r_b):>9.2e}")
            continue
        q4, k4, v4 = (a.view(1, bh, t, dd).detach().requires_grad_() for a in (q, k, v))
        g4 = g.view(1, bh, t, dd)
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
        sdpa_both = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), g4), 20)
        row = {"shape": list(shape), "dtype": dt, "variant": variant, "chunks": p.chunks,
               "splits": p.key_splits, "stages": p.stages, "tile": bp.tile,
               "bwd_stages": bp.stages, "lse_rel_err": r_lse}
        for name, fn, simt, plain, flops, nbytes, d, r, lib in (
                ("forward", lambda: A.attention(q, k, v), lambda: A.attention(q, k, v, variant="simt"),
                 lambda: A.attention(q, k, v, use_kernel=False), 4.0 * bh * t * t * dd,
                 4.0 * q.numel() * q.element_size(), d_f, r_f, sdpa_fwd),
                ("backward", lambda: A.attention_backward(q, k, v, out, g, lse),
                 lambda: A.attention_backward(q, k, v, out, g, variant="simt"),
                 lambda: A.attention_backward_reference(q, k, v, out, g), 10.0 * bh * t * t * dd,
                 8.0 * q.numel() * q.element_size(), d_b, r_b, sdpa_both - sdpa_fwd)):
            k_ms, s_ms, p_ms = time_ms(fn, 20), time_ms(simt, 3), time_ms(plain, 5)
            if dt == "float32":     # the tf32x3 design's bound, and any fp32 CUDA-core kernel's
                b_ms, b_by, ops_ms, bytes_ms = bound(TF32_PRODUCTS * flops, nbytes, "tf32")
                fp32c_ms = bound(flops, nbytes, "float32")[0]
            else:
                b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
                fp32c_ms = None
            row[name] = dict(ms=k_ms, simt_ms=s_ms, plain_ms=p_ms, library_ms=lib, bound_ms=b_ms,
                             bound_by=b_by, ops_ms=ops_ms, bytes_ms=bytes_ms,
                             fp32_cores_bound_ms=fp32c_ms, max_abs_err=d, rel_err=r)
            log(f"{str(shape):>24} {dt:>8} {name:>8} {variant:>6} {p.chunks:>2} {k_ms:>10.4f} "
                f"{s_ms:>9.4f} {p_ms:>9.4f} {lib:>9.4f} {ops_ms:>9.5f} {bytes_ms:>9.5f} "
                f"{'' if fp32c_ms is None else f'{fp32c_ms:.5f}':>9} {r:>9.2e}")
            if not 2 * k_ms <= s_ms:
                failures.append(f"{shape} {dt} {name}: {k_ms:.4f} ms, more than half of forced "
                                f"simt's {s_ms:.4f} ms")
        rows.append(row)
    log(f"attention past d = 128: worst rel err bf16 {worst['bfloat16']:.3e} (tol "
        f"{TOL['bfloat16']}), fp32 {worst['float32']:.3e} of max|plain| (tol {TOL['float32']}); "
        f"{len(cases)} shapes, {len(failures)} failures")
    for tag in ("forward", "backward"):
        for dt in ("float32", "bfloat16"):
            mine = [r for r in rows if r["dtype"] == dt]
            log(f"  {tag} {dt}: kernel / forced simt "
                + ", ".join(f"{tuple(r['shape'])} {r[tag]['ms'] / r[tag]['simt_ms']:.3f}" for r in mine))
            log(f"  {tag} {dt}: kernel / SDPA "
                + ", ".join(f"{tuple(r['shape'])} {r[tag]['ms'] / r[tag]['library_ms']:.3f}"
                            for r in mine))
    if failures:
        raise AssertionError("attention past d = 128:\n  " + "\n  ".join(failures))
    return rows


def wide_kernel_rows(attn_wide, wide_unet, src):
    """The `kernels` line's rows of the kernels past d = 128, one per dtype:
    forward and backward per UNet pass at phase 5b's 2-head calls (d = 256;
    the 1-head pass, d = 512, beside), each the sum of phase 3's times at
    those shapes; the launches of phase 5b (its forward checks and
    gradients); phase 3's rows at every wide shape."""
    keys = ("ms", "simt_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    out = []
    for dt, variant, source in (("bfloat16", "mma", "attention_wide_mma.cu"),
                                ("float32", "tf32x3", "attention_wide_tf32x3.cu")):
        rows = {tuple(r["shape"]): r for r in attn_wide if r["dtype"] == dt}

        def per_pass(part, heads):
            tot = {k: sum(rows[tuple(c)][part][k] for c in wide_unet[heads]["attention_calls"])
                   for k in keys}
            tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
            tot["max_abs_err"] = max(r[part]["max_abs_err"] for r in rows.values())
            return tot

        n_fwd = sum(u[dt]["forward_launches"] + u[dt]["gradient_launches"]["wide"][0]
                    for u in wide_unet.values())
        n_bwd = sum(u[dt]["gradient_launches"]["wide"][1] for u in wide_unet.values())
        fwd, bwd = per_pass("forward", 2), per_pass("backward", 2)
        out.append({"name": f"attention_wide_{variant}", "route": "cuda", "source": src + source,
                    "replaces": "diffusion_models_dev_project_tpu/ops/attention.py:43",
                    "launches": n_fwd, **fwd, "d": wide_unet[2]["d"],
                    "d512": per_pass("forward", 1),
                    "backward": {"source": src + source, "launches": n_bwd, **bwd,
                                 "d512": per_pass("backward", 1)},
                    "wide_heads": list(rows.values())})
    return out


# phase 5b: the flagship's UNet with one head per `num_heads` over all of a
# block's channels (num_head_channels = -1, guided-diffusion's default): at
# the 512-channel 16² and 8² maps 2 heads give d = 256 and 1 head d = 512
WIDE_UNET_HEADS = (2, 1)
# the fp32 UNet forward with kernels against its plain path: free of bf16
# rounding, as phase 5's fp32 gradient (TOL_GRAD_FP32)


def draw_zero_leaves(model, seed: int) -> None:
    """Draw the kernels a fresh UNet starts at zero (each attention `proj`,
    each res block's second conv, the final conv) from N(0, 1/fan_in)
    clipped at two standard deviations, in fp32 from a CPU generator of
    `seed`: so that every block carries signal and gradient, with the same
    values whatever the model's dtype."""
    import torch

    from diffusion_models_dev_project_tpu_torch.models import unet as U

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (U.Conv3x3, U.Dense)) and not mod.weight.any():
                w = mod.weight
                fan_in = 9 * w.shape[2] if isinstance(mod, U.Conv3x3) else w.shape[1]
                w.copy_(torch.randn(w.shape, generator=g).clamp(-2, 2) / math.sqrt(fan_in))


def wide_head_unet_phase(F, config, sde, trafo, obs, xg, tg):
    """Phase 5b: the flagship's 128-channel UNet with random weights (the
    config's seed, `draw_zero_leaves`) and num_head_channels = -1, once with
    2 heads (its attention at d = 256) and once with 1 (d = 512), in bf16
    and fp32: one forward at 256², batch 1, kernels against
    `use_kernel=False` (`TOL_UNET` in bf16, `TOL_GRAD_FP32` in fp32), and
    the LoRA adaptation loss's gradient of phase 5 (its observation and
    state) under phase 5's gates; exact launch counts, every attention call
    a wide one: 4 forwards per forward pass and 4 backwards per backward.
    Draws from a generator of its own.  Returns {heads: {...}}."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    own = torch.Generator(device="cuda").manual_seed(55)
    x = torch.randn((1, 256, 256, 1), generator=own, device="cuda") * 10.0
    t = torch.full((1,), 0.5, device="cuda")
    out = {}
    for heads in WIDE_UNET_HEADS:
        cfgs, models = {}, {}
        for dt in ("bfloat16", "float32"):
            cfgs[dt] = copy.deepcopy(config)
            cfgs[dt].model.dtype = dt
            cfgs[dt].model.num_heads = heads
            cfgs[dt].model.num_head_channels = -1
            models[dt], _, _ = F.get_standard_score(cfgs[dt], sde, load_model=False,
                                                    lora_rank=LORA_RANK)
            draw_zero_leaves(models[dt], 5)
        seen, handles = record_shapes(models["bfloat16"])
        with torch.no_grad():
            models["bfloat16"](x, t)
        for hnd in handles:
            hnd.remove()
        shapes = sorted({shape for shape, _ in seen["attn"]})
        dd = shapes[0][2]
        row = {"d": dd, "attention_calls": [list(sh) for sh, _ in seen["attn"]]}
        for dt, m in models.items():
            reset_counts()
            A.wide_launches = A.wide_backward_launches = 0
            with torch.no_grad():
                y = m(x, t)
                counts, wide = read_counts(), (A.wide_launches, A.wide_backward_launches)
                ref = m(x, t, use_kernel=False)
                dev_ms = time_ms(lambda: m(x, t), 3)
            check_counts(counts, 1, 0, f"wide heads ({heads}) {dt} forward", dtype=dt)
            d_f, r_f = rel_err(y, ref)
            tol = TOL_UNET if dt == "bfloat16" else TOL_GRAD_FP32
            log(f"  UNet 256², {heads} head(s) of d = {dd} ({len(seen['attn'])} attention calls at "
                f"{shapes}), {dt}: max|kernel - plain| {d_f:.3e}, rel {r_f:.3e} (tol {tol}); wide "
                f"launches {wide[0]}; forward {dev_ms:.2f} ms of device time")
            if not (torch.isfinite(y).all() and y.shape == x.shape and r_f <= tol
                    and wide == (4, 0)):
                raise AssertionError(f"wide heads ({heads}) {dt}: the UNet forward with kernels "
                                     f"disagrees with the plain path, or wide launches {wide}")
            row[dt] = {"rel_err": r_f, "max_abs_err": d_f, "forward_device_ms": dev_ms,
                       "forward_launches": wide[0]}
        samplers = {dt: F.get_standard_adapted_sampler(
            "dds", m, sde, trafo, obs, num_steps=50, lora_rank=LORA_RANK, add_cg=True, cg_iter=1,
            dc_type="cg", tv_penalty=1e-6, lr=1e-3) for dt, m in models.items()}
        lora = {n: (v if n.endswith(".down") else 0.01 * torch.randn(v.shape, generator=own,
                                                                     device="cuda"))
                for n, v in samplers["bfloat16"].lora.items()}
        for smp in samplers.values():
            smp.lora = lora
        grads = {}
        for dt, smp in samplers.items():
            reset_counts()
            A.wide_launches = A.wide_backward_launches = 0
            grads[dt, True] = adaptation_gradients(smp, xg, tg, True)
            counts, wide = read_counts(), (A.wide_launches, A.wide_backward_launches)
            check_counts(counts, 1, 1, f"wide heads ({heads}) {dt} gradient", dtype=dt)
            if wide != (4, 4):
                raise AssertionError(f"wide heads ({heads}) {dt} gradient: wide launches {wide}")
            row[dt]["gradient_launches"] = {"attn_fwd_by": counts["attn_fwd_by"],
                                            "attn_bwd_by": counts["attn_bwd_by"], "wide": wide}
            grads[dt, False] = adaptation_gradients(smp, xg, tg, False)
        (loss_k, gk), (loss_p, gp) = grads["bfloat16", True], grads["bfloat16", False]
        (loss_32k, g32k), (loss_32, g32) = grads["float32", True], grads["float32", False]
        gradient_gates(gk, gp, g32, g32k, (loss_k, loss_p, loss_32, loss_32k),
                       f"adaptation loss gradient, {heads} head(s) of d = {dd}")
        out[heads] = row
        del samplers, models, grads
    return out


def adapted_phantoms(images):
    """(name, image) of the adapted phase: val image 0 and the OOD bars phantom
    (the adapted evaluation's, `scripts/eval_adapted_256.py::ood_bars`)."""
    from diffusion_models_dev_project_tpu_torch.scripts.eval_adapted_256 import ood_bars

    return [("val image 0", images[0]), ("OOD bars", ood_bars(256)[..., None])]


def adapted_sampler(F, model, sde, trafo, obs, gt, n_steps: int, lora_seed: int,
                    n_optim: int = ADAPT_PROTOCOL_OPTIM):
    """The adapted protocol's sampler: LoRA rank 4 drawn from `lora_seed`,
    `n_optim` (the protocol's 10) Adam steps at lr 1e-3 per outer step, TV
    1e-6, eta 0.85, gamma 0.01, cg(1), add_cg; `F` is the port's factory
    module."""
    return F.get_standard_adapted_sampler(
        "dds", model, sde, trafo, obs, num_steps=n_steps, eta=0.85, gamma=0.01,
        tv_penalty=1e-6, lr=1e-3, num_optim_step=n_optim, adapt_freq=1, lora_rank=LORA_RANK,
        add_cg=True, dc_type="cg", cg_iter=1, ground_truth=gt, lora_seed=lora_seed)


class AdaptTimer:
    """CUDA events around each outer step's adaptation and its two score
    forwards (adapted, then prior), from the sampler's own calls: a step
    runs from one adaptation's start to the next's."""

    def __init__(self, sampler):
        self.steps, self.inner = [], False
        adapt, score = sampler.adapt_step, sampler.score

        def timed_adapt(x, t, *images):
            start = StepTimer._event()
            self.inner = True
            adapt(x, t, *images)
            self.inner = False
            self.steps.append({"start": start, "adapted": StepTimer._event(), "fwd": []})

        def timed_score(x, t, lora_scale, use_kernel=True, leaves=None):
            if self.inner or not self.steps:
                return score(x, t, lora_scale, use_kernel, leaves)
            e0 = StepTimer._event()
            out = score(x, t, lora_scale, use_kernel, leaves)
            self.steps[-1]["fwd"].append((e0, StepTimer._event()))
            return out

        sampler.adapt_step, sampler.score = timed_adapt, timed_score

    def split(self):
        """Per outer step but the last, ms of the step, the adaptation, the
        adapted and the prior forward, and the rest."""
        import torch

        torch.cuda.synchronize()
        rows = []
        for cur, nxt in zip(self.steps, self.steps[1:]):
            step = cur["start"].elapsed_time(nxt["start"])
            adapt = cur["start"].elapsed_time(cur["adapted"])
            f1, f0 = (a.elapsed_time(b) for a, b in cur["fwd"][:2])
            rows.append({"step": step, "adapt": adapt, "fwd_adapted": f1, "fwd_prior": f0,
                         "rest": step - adapt - f1 - f0})
        return rows


def reset_counts():
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    C.launches = C.backward_launches = C.wgrad_launches = A.launches = A.backward_launches = 0
    C.launches_by_variant = dict.fromkeys(C.VARIANTS, 0)
    C.backward_launches_by_variant = dict.fromkeys(C.VARIANTS, 0)
    C.wgrad_launches_by_variant = dict.fromkeys(C.WGRAD_VARIANTS, 0)
    A.launches_by_variant = dict.fromkeys(A.VARIANTS, 0)
    A.backward_launches_by_variant = dict.fromkeys(A.VARIANTS, 0)


def read_counts():
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    return {"conv_fwd": C.launches, "conv_fwd_by": dict(C.launches_by_variant),
            "conv_bwd": C.backward_launches, "conv_bwd_by": dict(C.backward_launches_by_variant),
            "conv_wgrad": C.wgrad_launches, "conv_wgrad_by": dict(C.wgrad_launches_by_variant),
            "attn_fwd": A.launches, "attn_fwd_by": dict(A.launches_by_variant),
            "attn_bwd": A.backward_launches, "attn_bwd_by": dict(A.backward_launches_by_variant)}


def by_variants(variants, **counts):
    """{variant: count} over `variants`, 0 where `counts` names none."""
    return {v: counts.get(v, 0) for v in variants}


def check_counts(counts, n_fwd, n_bwd, what, stem_grad=False, per_backward=None,
                 dtype="bfloat16"):
    """Per forward 62 conv3x3 (60 tc, 1 narrow, 1 simt) and 4 attention
    (mma); per backward, by default (LoRA: frozen base weights), 61 conv3x3
    input gradients (60 tc, 1 simt: the final conv's, whose gradient has
    Cin = 1), no weight gradient and 4 attention backwards (mma).  With
    `dtype` "float32" (the CLIs' default) the 60 and attention take
    `tf32x3`, forward and backward.  With
    `stem_grad` (a gradient in the diffusion state x, as DPS takes it) the
    backward also takes the stem's input gradient, whose swapped shape
    (Cin 128 -> Cout 1) runs on `narrow`: 62 per backward.  `per_backward`
    (from `backward_pattern`) replaces the backward's counts where base
    weights train."""
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    hot, attn = ("tc", "mma") if dtype == "bfloat16" else ("tf32x3", "tf32x3")
    n_stem = n_bwd if stem_grad else 0
    pb = per_backward or {"conv_bwd_by": by_variants(C.VARIANTS, **{hot: 60, "simt": 1}),
                          "conv_wgrad_by": dict.fromkeys(C.WGRAD_VARIANTS, 0), "attn_bwd": 4}
    bwd_by = {v: k * n_bwd for v, k in pb["conv_bwd_by"].items()}
    bwd_by["narrow"] += n_stem
    wgrad_by = {v: k * n_bwd for v, k in pb["conv_wgrad_by"].items()}
    want = {"conv_fwd": 62 * n_fwd,
            "conv_fwd_by": by_variants(C.VARIANTS, **{hot: 60 * n_fwd, "narrow": n_fwd, "simt": n_fwd}),
            "conv_bwd": sum(bwd_by.values()), "conv_bwd_by": bwd_by,
            "conv_wgrad": sum(wgrad_by.values()), "conv_wgrad_by": wgrad_by,
            "attn_fwd": 4 * n_fwd, "attn_fwd_by": by_variants(A.VARIANTS, **{attn: 4 * n_fwd}),
            "attn_bwd": pb["attn_bwd"] * n_bwd,
            "attn_bwd_by": by_variants(A.VARIANTS, **{attn: pb["attn_bwd"] * n_bwd})}
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, want {want} for {n_fwd} forwards "
                             f"and {n_bwd} backwards")


def module_calls(model, x, t):
    """(kind, module name, x shape, Cout, dtype) of each conv3x3 ("conv") and
    attention block ("attn", shapes None) call of one forward of `model` on
    (x, t), in call order."""
    import torch

    from diffusion_models_dev_project_tpu_torch.models import unet as U

    calls, handles = [], []
    for name, m in model.named_modules():
        if isinstance(m, U.Conv3x3):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: calls.append(
                    ("conv", name, tuple(args[0].shape), mod.weight.shape[-1], mod.dtype))))
        elif isinstance(m, U.AttentionBlock):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: calls.append(("attn", name, None, None, None))))
    with torch.no_grad():
        model(x, t)
    for hnd in handles:
        hnd.remove()
    return calls


def backward_pattern(calls, trains):
    """Launches per backward of a loss of the UNet's output, derived from the
    model's structure (`calls` of `module_calls`, `trains(conv name)` whether
    the conv's weight trains): a weight gradient for each trained conv; an
    input gradient for each conv from the first trained one on but the
    stem, whose input is the diffusion state (every block of the trained
    sets starts with a trained GroupNorm, so under `decoder` no encoder or
    middle conv takes one); each on the variant its plan picks; an attention
    backward for each block after the first trained conv."""
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    bwd_by, wgrad_by = dict.fromkeys(C.VARIANTS, 0), dict.fromkeys(C.WGRAD_VARIANTS, 0)
    attn_bwd, downstream = 0, False
    for i, (kind, name, shape, cout, dt) in enumerate(calls):
        if kind == "attn":
            attn_bwd += downstream
            continue
        b, h, w, cin = shape
        if trains(name):
            wgrad_by[C.wgrad_plan(b, h, w, cin, cout, dt).variant] += 1
            downstream = True
        if downstream and i > 0:
            bwd_by[C.plan(b, h, w, cout, cin, dt).variant] += 1
    return {"conv_bwd_by": bwd_by, "conv_wgrad_by": wgrad_by, "attn_bwd": attn_bwd}


class PredictorTimer:
    """CUDA events at the start of each Euler-Maruyama predictor step and
    around the gradient of its data fit (`predictors._value_and_grad`: for
    DPS the score's forward and backward, for naive the data fit alone),
    from the sampler's own calls; `remove()` puts the functions back."""

    def __init__(self, P):
        self.P, self.starts, self.grads = P, [], []
        self._step, self._value_and_grad = P.euler_maruyama_step, P._value_and_grad

        def step(*a, **k):
            self.starts.append(StepTimer._event())
            return self._step(*a, **k)

        def value_and_grad(*a, **k):
            e0 = StepTimer._event()
            out = self._value_and_grad(*a, **k)
            self.grads.append((e0, StepTimer._event()))
            return out

        P.euler_maruyama_step, P._value_and_grad = step, value_and_grad

    def remove(self):
        self.P.euler_maruyama_step, self.P._value_and_grad = self._step, self._value_and_grad

    def split(self, last: int):
        """(ms per step over the run, medians over the `last` steps before
        the final one of the step and its gradient part)."""
        import torch

        torch.cuda.synchronize()
        if len(self.grads) != len(self.starts) or len(self.starts) < 2:
            raise AssertionError(f"{len(self.starts)} predictor steps, {len(self.grads)} gradients")
        n = len(self.starts)
        rows = [(a.elapsed_time(b), g0.elapsed_time(g1))
                for a, b, (g0, g1) in zip(self.starts, self.starts[1:], self.grads)][-last:]
        return (self.starts[0].elapsed_time(self.starts[-1]) / (n - 1),
                float(np.median([r[0] for r in rows])), float(np.median([r[1] for r in rows])))


def read_report(path) -> dict:
    """PSNR, SSIM and (the conditional CLI's) diverged_images of a CLI's
    report.yaml."""
    import re

    text = open(path, encoding="utf-8").read()
    out = {k: float(re.search(rf"^{k}: (\S+)$", text, re.M).group(1)) for k in ("PSNR", "SSIM")}
    diverged = re.search(r"^diverged_images: (.*)$", text, re.M)
    out["diverged_images"] = diverged.group(1) if diverged else None
    return out


def adaptation_gradients(sampler, x, t, use_kernel):
    """(loss, {leaf: gradient}) of the sampler's adaptation loss at (x, t),
    from its start state."""
    import torch

    with sampler.adapting():
        names = list(sampler.trainable)
        loss = sampler.adaptation_loss(x, t, use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, [sampler.trainable[n] for n in names])
    return float(loss.detach()), dict(zip(names, grads))


def lora_leaf_errors(gk, gp):
    """Per leaf |g_k - g_p| / |g_p| (2-norms), and the same over all leaves."""
    import torch

    per = {}
    num = den = 0.0
    for name in gp:
        diff = float(torch.linalg.vector_norm((gk[name] - gp[name]).double()))
        ref = float(torch.linalg.vector_norm(gp[name].double()))
        per[name] = diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)
        num, den = num + diff ** 2, den + ref ** 2
    return per, math.sqrt(num / den)


def gradient_gates(gk, gp, g32, g32k, losses, what):
    """The gates of a full-width parameter gradient: bf16 kernels against
    bf16 plain over all leaves (`TOL_GRAD_ALL`); per leaf the bf16 kernels'
    distance from the fp32 plain gradient at most `TOL_GRAD_LEAF_FACTOR`
    times the bf16 plain path's own or `TOL_GRAD_LEAF`; fp32 kernels
    against fp32 plain per leaf (`TOL_GRAD_FP32`).  `losses`: (bf16
    kernels, bf16 plain, fp32 plain, fp32 kernels)."""
    import torch

    per_kp, total_kp = lora_leaf_errors(gk, gp)
    per_k32, total_k32 = lora_leaf_errors(gk, g32)
    per_p32, total_p32 = lora_leaf_errors(gp, g32)
    per_f32, total_f32 = lora_leaf_errors(g32k, g32)
    n_lora = sum(n.endswith((".down", ".up")) for n in gk)
    slack = {n: per_k32[n] - max(TOL_GRAD_LEAF_FACTOR * per_p32[n], TOL_GRAD_LEAF) for n in gk}
    worst = sorted(gk, key=lambda n: -slack[n])[:5]
    loss_k, loss_p, loss_32, loss_32k = losses
    log(f"  {what}: {len(gk)} trainable leaves ({n_lora} LoRA, {len(gk) - n_lora} base), "
        f"{sum(g.numel() for g in gk.values()) / 1e6:.2f}M values; loss bf16 kernels {loss_k:.6e}, "
        f"bf16 plain {loss_p:.6e}, fp32 plain {loss_32:.6e}, fp32 kernels {loss_32k:.6e}")
    log(f"  |g_a - g_b| / |g_b| over all leaves: bf16 kernels vs bf16 plain {total_kp:.3e} (tol "
        f"{TOL_GRAD_ALL}); vs the fp32 plain gradient: bf16 kernels {total_k32:.3e}, bf16 plain "
        f"{total_p32:.3e}; fp32 kernels vs fp32 plain {total_f32:.3e}, worst leaf "
        f"{max(per_f32.values()):.3e} (tol {TOL_GRAD_FP32})")
    log(f"  per leaf, distance from the fp32 gradient, bf16 kernels against bf16 plain (tol "
        f"max({TOL_GRAD_LEAF_FACTOR} x plain, {TOL_GRAD_LEAF})), closest to the bound: "
        + ", ".join(f"{n} {per_k32[n]:.3e} vs {per_p32[n]:.3e}" for n in worst)
        + f"; largest per leaf: bf16 kernels vs bf16 plain {max(per_kp.values()):.3e}, distance "
        f"from the fp32 gradient {max(per_k32.values()):.3e} (bf16 kernels), "
        f"{max(per_p32.values()):.3e} (bf16 plain)")
    if not (math.isfinite(total_kp) and total_kp <= TOL_GRAD_ALL and max(slack.values()) <= 0
            and max(per_f32.values()) <= TOL_GRAD_FP32
            and all(torch.isfinite(v).all() for v in gk.values())):
        raise AssertionError(f"{what}: the full-width gradient with kernels disagrees with the "
                             "plain path")


# ---- phase 11: several images per call on the one card
SHARD_IMAGES = 4              # images per call (the CLIs' --shard_images)
# cut to fit the run's time limit (PERF.md §4): the conditional DDS of the
# four test-fold images runs this many steps (protocol 1000), the adapted
# runs 5 outer x 3 Adam steps (protocol 50 x 10), and the serial runs that
# the batched ones are held to take the first of the four images (the fp32
# chain of 11c holds two adapted images to their serial chains by tensors)
SHARD_DDS_STEPS = 50
SHARD_ADAPT_STEPS, SHARD_ADAPT_OPTIM = 5, 3
SHARD_SERIAL_IMAGES = 1
# the batched adapted chain held to the serial one by tensors: fp32 with the
# kernels, 2 images (val images 0 and 1, each its own LoRA state and its own
# injected draws), DDS on a 4-step grid with 3 Adam steps per outer step;
# each row's max|batched - serial| / max|serial| (JAX's own test of its
# batched mode holds rtol 1e-3: tests/test_adaptation.py), set before the
# first run (PERF.md §6)
SHARD_CHAIN_STEPS, SHARD_CHAIN_OPTIM = 4, 3
TOL_SHARD_CHAIN = 1e-3
# the runs whose device busy share a torch.profiler trace reads, at 1 image
# and at SHARD_IMAGES: the last DDS steps of the 100-step grid, and the first
# adapted outer steps (the CLI's 3 Adam steps) of the 5-step grid
SHARD_TRACE_DDS_STEPS = 10
SHARD_TRACE_STEPS = 1
# each batched image's PSNR within this of its serial run (dB), set before
# the first run (PERF.md §6): DDS draws its chunk's chain from one generator,
# so batched and serial differ by the draw; the adapted runs draw the same
# numbers, and differ by the batch's last bits (split-K by batch, bf16),
# which adaptation amplifies (adapted_spread.py: about 1 dB on a val image)
SHARD_DDS_AGREE_DB = 1.0
SHARD_ADAPT_AGREE_DB = 2.0


class CallTimer:
    """Wall seconds of calls to some methods of an object, each call ended
    by a synchronise of the card, summed by method name."""

    def __init__(self, obj, names):
        import torch

        self.seconds = dict.fromkeys(names, 0.0)
        self.calls = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(obj, name)

            def timed(*a, _fn=fn, _name=name, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                self.calls[_name] += 1
                return out

            setattr(obj, name, timed)


def run_cli(module, argv, workdir, patch=None):
    """`module.coordinator(argv)` in `workdir`, with `patch` = (factory
    module, name, wrap) swapping a factory function for the call; returns
    (output directory, wall seconds, launch counts, report)."""
    import torch

    cwd = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    orig = None
    if patch is not None:
        mod, name, wrap = patch
        orig = getattr(mod, name)
        setattr(mod, name, wrap(orig))
    try:
        torch.cuda.synchronize()
        reset_counts()
        ts = time.perf_counter()
        root = module.coordinator(module.parser.parse_args(argv))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - ts
        counts = read_counts()
    finally:
        if orig is not None:
            setattr(patch[0], patch[1], orig)
        os.chdir(cwd)
    root = os.path.join(workdir, root)
    return root, wall_s, counts, read_report(os.path.join(root, "report.yaml"))


def busy_share_profiled(fn, log_dir):
    """Device busy share of `fn` from the port's `utils/profiling.py::
    device_trace` (a torch.profiler trace, written to `log_dir`): the union
    of the device events' intervals (`device_busy_us`: each kernel, copy
    and memset once) over the wall time under the profiler, whose own cost
    on the host lowers the share (None where the trace holds no device
    time)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.utils.profiling import device_busy_us, device_trace

    torch.cuda.synchronize()
    with device_trace(log_dir):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = device_busy_us(os.path.join(log_dir, "trace.json"))
    return (dev_us / 1e3 / wall_ms) if dev_us > 0 else None


def batched_gradient_check(F, config, config32, sde, trafo, images, gen):
    """Phase 11c's first part: the full-width gradient of the batched
    adaptation loss for two images (val images 0 and 1 at t = 0.5, each its
    own LoRA state with nonzero up-projections), bf16 and fp32 with the
    kernels, and bf16 plain, each image's row under phase 5's gates against
    the image's serial fp32 gradient: bf16 kernels against bf16 plain in
    the same batched arithmetic, both against the serial fp32 gradient, fp32
    kernels against it per leaf.  (bf16 rounding moves this loss's gradient
    by about a tenth from fp32 either way, so a bf16 gradient taken in
    another order, the serial one, differs by as much: printed, not gated.)
    Returns (the bf16 and the fp32 LoRA model, the two observations, the
    two images' noised states)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import init_lora

    m16, _, _ = F.get_standard_score(config, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
    m32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
    obs2, xs, ts = [], [], torch.full((1,), 0.5, device="cuda")
    for j in range(2):
        g = torch.Generator(device="cuda").manual_seed(config.seed + j)
        gt, obs, _ = F.get_data_from_ground_truth(images[j], trafo, config.data.stddev, generator=g)
        obs2.append(obs)
        xs.append(gt + sde.marginal_prob_std(ts).reshape(1, 1, 1, 1) * torch.randn(
            gt.shape, generator=gen, device="cuda"))
    x2, t2 = torch.cat(xs), torch.full((2,), 0.5, device="cuda")
    smps = {name: F.get_standard_adapted_sampler(
        "dds", m, sde, trafo, obs2[0], num_steps=50, lora_rank=LORA_RANK, add_cg=True, cg_iter=1,
        dc_type="cg", tv_penalty=1e-6, lr=1e-3) for name, m in (("bf16", m16), ("fp32", m32))}
    loras = []
    for j in range(2):          # every up-projection nonzero, so that every branch carries gradient
        st = init_lora(m16, seed=j)
        loras.append({k: (v if k.endswith(".down") else
                          0.01 * torch.randn(v.shape, generator=gen, device="cuda"))
                      for k, v in st.items()})
    stack = {k: torch.stack([lo[k] for lo in loras]) for k in loras[0]}

    def batched_grads(smp, use_kernel):
        flags = {nm: p.requires_grad for nm, p in smp.model.named_parameters()}
        smp.model.requires_grad_(False)
        try:
            imgs = smp.batched_inputs(torch.stack(obs2), stack)
            loss = smp.adaptation_loss(x2, t2, use_kernel=use_kernel, images=imgs)
            grads = torch.autograd.grad(loss, list(imgs.leaves.values()))
        finally:
            for nm, p in smp.model.named_parameters():
                p.requires_grad_(flags[nm])
        return float(loss.detach()), dict(zip(imgs.leaves, grads))

    def serial_grads(smp, j, use_kernel):
        smp.observation, smp.rhs, smp.lora = obs2[j], trafo.adjoint(obs2[j]), loras[j]
        return adaptation_gradients(smp, xs[j], ts, use_kernel)

    reset_counts()
    loss_bk, gbk = batched_grads(smps["bf16"], True)
    counts = read_counts()
    check_counts(counts, 1, 1, "one forward and backward of the batched adaptation loss")
    loss_bk32, gbk32 = batched_grads(smps["fp32"], True)
    loss_bp, gbp = batched_grads(smps["bf16"], False)
    serial = {j: (serial_grads(smps["bf16"], j, False), serial_grads(smps["fp32"], j, False))
              for j in range(2)}
    for j in range(2):
        (lp, gp), (l32, g32) = serial[j]
        gk = {k: v[j] for k, v in gbk.items()}
        g32k = {k: v[j] for k, v in gbk32.items()}
        gbp_j = {k: v[j] for k, v in gbp.items()}
        # bf16 kernels against bf16 plain in the same (batched) arithmetic, both
        # against the image's serial fp32 gradient; fp32 batched kernels
        # against it per leaf (1e-3): what shows that the images do not couple
        gradient_gates(gk, gbp_j, g32, g32k, (loss_bk, loss_bp, l32, loss_bk32),
                       f"image {j} of the batched adaptation loss (2 images, batched: bf16 "
                       f"kernels, bf16 plain, fp32 kernels) against its serial loss (fp32 plain)")
        log(f"  image {j}, not gated: the bf16 serial plain gradient lies "
            f"{lora_leaf_errors(gp, g32)[1]:.3e} from the serial fp32 one and "
            f"{lora_leaf_errors(gbp_j, gp)[1]:.3e} from the batched bf16 plain one (bf16 rounding "
            f"of this loss's gradient, in another order; serial bf16 loss {lp:.6e})")
    del gbk, gbk32, gbp, serial, smps
    log("  launches of one forward and backward of the batched loss at 2 images: "
        + json.dumps(counts))
    return m16, m32, obs2, x2


def batched_chain_check(F, m32, sde, trafo, obs2, gen):
    """Phase 11c's second part: the whole batched adapted chain, held by
    tensors to each image's serial chain.  `sample_batched` under `lora`
    in fp32 with the kernels, for the two observations of
    `batched_gradient_check`, each image with its own `init_lora` state
    (seed = its index, as the CLI draws them) and its own injected draws;
    then each image alone through `sample` with the same state and draws.
    What couples images or mixes up their leaves, Adam states, draws or
    observations shows here, over the chain's adaptations."""
    import torch

    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import init_lora

    smp = F.get_standard_adapted_sampler(
        "dds", m32, sde, trafo, obs2[0], num_steps=SHARD_CHAIN_STEPS, eta=0.85, gamma=0.01,
        tv_penalty=1e-6, lr=1e-3, num_optim_step=SHARD_CHAIN_OPTIM, adapt_freq=1,
        lora_rank=LORA_RANK, add_cg=True, dc_type="cg", cg_iter=1)
    loras = [init_lora(m32, seed=j) for j in range(2)]
    stack = {k: torch.stack([lo[k] for lo in loras]) for k in loras[0]}
    noises = [[torch.randn((1, 256, 256, 1), generator=gen, device="cuda")
               for _ in range(smp.num_draws)] for _ in range(2)]
    reset_counts()
    xb = smp.sample_batched(torch.stack(obs2), noises=noises, lora_stack=stack)
    torch.cuda.synchronize()
    counts = read_counts()
    n_fwd = SHARD_CHAIN_STEPS * (SHARD_CHAIN_OPTIM + 2) + 1
    n_bwd = SHARD_CHAIN_STEPS * SHARD_CHAIN_OPTIM
    want = {"conv_fwd": 62 * n_fwd, "attn_fwd": 4 * n_fwd, "conv_bwd": 61 * n_bwd,
            "conv_wgrad": 0, "attn_bwd": 4 * n_bwd}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"the batched fp32 chain: launch counts {counts}, want {want}")
    errs = []
    for j in range(2):
        smp.observation, smp.rhs, smp.lora = obs2[j], trafo.adjoint(obs2[j]), loras[j]
        xs, _ = smp.sample(noises=noises[j])
        if not (xb.shape == (2, 1, 256, 256, 1) and torch.isfinite(xb[j]).all()):
            raise AssertionError(f"the batched fp32 chain's image {j} is not finite or of the "
                                 "wrong shape")
        errs.append(float((xb[j] - xs).abs().max() / xs.abs().max()))
    log(f"  batched adapted chain (lora, fp32 with the kernels, 2 images, {SHARD_CHAIN_STEPS} x "
        f"{SHARD_CHAIN_OPTIM}, injected draws) against each image's serial chain: max|diff| / "
        f"max|serial| " + ", ".join(f"image {j} {e:.3e}" for j, e in enumerate(errs))
        + f" (tol {TOL_SHARD_CHAIN:g}); launches " + json.dumps(counts))
    if not max(errs) <= TOL_SHARD_CHAIN:
        raise AssertionError(f"the batched adapted chain differs from the serial one: {errs}")
    return errs


def multi_image_phase(F, P, CLI, ACLI, model, config, config32, sde, trafo, images, gen, workdir,
                      dev_times):
    """Phase 11: 11a the forward kernels with a bias per image; 11b the
    conditional CLI's `--shard_images`; 11c the adapted CLI's under `lora`,
    after the batched adaptation loss's full-width gradient for two
    images against each image's serial gradient.  Returns what the kernel
    summary needs."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops.cg import cg
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR, SSIM

    n = SHARD_IMAGES
    out = {}
    # ---- 11a. the per-image bias at every conv shape of a batch-n forward
    t0 = time.perf_counter()
    x4 = torch.randn((n, 256, 256, 1), generator=gen, device="cuda") * 10.0
    t4 = torch.full((n,), 0.5, device="cuda")
    seen, handles = record_shapes(model)
    with torch.no_grad():
        model(x4, t4)
    for hnd in handles:
        hnd.remove()
    out["bias_tot"], out["bias_err"], out["bias_variants"] = check_conv_bias(seen["conv"], gen)
    with torch.no_grad():
        fwd4_dev = time_ms(lambda: model(x4, t4), 5)
    log(f"  UNet forward at batch {n}: {fwd4_dev:.2f} ms of device time (graph replay), against "
        f"{dev_times['fwd']:.2f} ms at batch 1 (phase 4): {fwd4_dev / dev_times['fwd']:.2f}x for "
        f"{n}x the images")
    log(f"[phase 11a per-image bias] {time.perf_counter() - t0:.1f} s")

    # ---- 11b. the conditional CLI: n images per call, then the first k serially
    t0 = time.perf_counter()
    k = SHARD_SERIAL_IMAGES
    base = ["--load_path", CKPT, "--num_channels", "128", "--method", "dds", "--eta", "0.85",
            "--num_steps", str(SHARD_DDS_STEPS)]
    images_of = {"batched": n, "serial": k}
    runs = {}
    for mode, argv in (("batched", base + ["--num_images", str(n), "--shard_images", str(n)]),
                       ("serial", base + ["--num_images", str(k)])):
        timers = []

        def wrap(make):
            def made(*a, **k):
                smp = make(*a, **k)
                timer = StepTimer(smp.score_fn, cg, first_step=SHARD_DDS_STEPS // 2)
                smp.score_fn = timer.score
                timers.append((timer, CallTimer(smp, ["sample"])))
                return smp
            return made

        P.cg = lambda *a, **k: timers[-1][0].cg(*a, **k) if timers else cg(*a, **k)
        try:
            root, wall_s, counts, report = run_cli(CLI, argv, os.path.join(workdir, mode),
                                                   (F, "get_standard_sampler", wrap))
        finally:
            P.cg = cg
        timer, calls = timers[0]
        timer.finish()
        rows = timer.split()
        med = {k: float(np.median([r[k] for r in rows])) for k in ("step", "unet", "cg", "rest")}
        recs = []
        for i in range(images_of[mode]):
            with np.load(os.path.join(root, f"recon_{i}_info.npz")) as info:
                recs.append((info["recon"], info["ground_truth"]))
        runs[mode] = dict(root=root, wall_s=wall_s, counts=counts, report=report, med=med,
                          sample_s=calls.seconds["sample"], recs=recs)
        n_fwd = SHARD_DDS_STEPS * (1 if mode == "batched" else k)
        check_counts(counts, n_fwd, 0, f"DDS of {images_of[mode]} images through the CLI, {mode}")
        if mode == "batched" and report["diverged_images"] != "[]":
            raise AssertionError(f"batched DDS diverged: {report['diverged_images']}")
    rows_out = []
    for i in range(n):
        rb, g_np = runs["batched"]["recs"][i]
        rs, g_s = runs["serial"]["recs"][i] if i < k else (None, g_np)
        if not (np.array_equal(g_np, g_s) and rb.shape == (256, 256) and np.isfinite(rb).all()):
            raise AssertionError(f"conditional image {i}: batched and serial differ in their image, "
                                 "or the batched reconstruction is not finite")
        g = torch.Generator(device="cuda").manual_seed(config.seed * 1000 + i)
        _, _, fbp = F.get_data_from_ground_truth(g_np[..., None], trafo, config.data.stddev,
                                                 generator=g)
        f_np = fbp[0, ..., 0].cpu().numpy()
        pb, pf = PSNR(rb, g_np), PSNR(f_np, g_np)
        ps = None if rs is None else PSNR(rs, g_np)
        rows_out.append((pb, ps, pf))
        log(f"  test-fold image {i}: DDS batched ({n} per call) {pb:.2f} dB / {SSIM(rb, g_np):.4f} "
            + ("SSIM | not run serially" if rs is None else
               f"SSIM | serial {ps:.2f} dB / {SSIM(rs, g_np):.4f}")
            + f" | FBP {pf:.2f} dB / {SSIM(f_np, g_np):.4f}")
    for i, (pb, ps, pf) in enumerate(rows_out):
        if not pb > pf:
            raise AssertionError(f"image {i}: batched DDS {pb:.2f} dB does not beat FBP {pf:.2f} dB")
        if ps is not None and abs(pb - ps) > SHARD_DDS_AGREE_DB:
            raise AssertionError(f"image {i}: batched DDS {pb:.2f} dB and serial {ps:.2f} dB differ "
                                 f"by more than {SHARD_DDS_AGREE_DB} dB")
    # busy share (at most): the device time of a step's UNet forward and CG(5)
    # (graph replay) over the median step inside the loop
    xh4 = torch.randn((n, 256, 256, 1), generator=gen, device="cuda")
    dc_op = P.make_dc_op(trafo.with_gram() if hasattr(trafo, "with_gram") else trafo, 0.01)
    rhs4 = trafo.adjoint(trafo.apply(xh4))
    cg4_dev = time_ms(lambda: cg(dc_op, xh4, xh4 + 0.01 * rhs4, n_iter=5), 5)
    dev = {"batched": fwd4_dev + cg4_dev, "serial": dev_times["fwd"] + dev_times["cg"]}
    # and from profiler traces of the grid's last steps at 1 and at n images
    prof_share = {}
    for mode, b in (("serial", 1), ("batched", n)):
        smp = F.get_standard_sampler("dds", lambda a, tt: model(a, tt), sde, trafo,
                                     trafo.apply(xh4[:b]), num_steps=SHARD_DDS_STEPS,
                                     batch_size=b, im_shape=(256, 256, 1), gamma=0.01, eta=0.85,
                                     cg_iter=5)
        smp._time_data = tuple(a[-SHARD_TRACE_DDS_STEPS:] if isinstance(a, np.ndarray) else a
                               for a in smp._time_data)
        tc0 = time.perf_counter()
        prof_share[mode] = busy_share_profiled(lambda: smp.sample(generator=gen),
                                               os.path.join(workdir, "trace_" + mode))
        log(f"  (the DDS profiler trace at {b} image(s): {time.perf_counter() - tc0:.1f} s)")
    out["dds"] = {}
    for mode in ("serial", "batched"):
        r = runs[mode]
        per_image = r["sample_s"] / images_of[mode]
        share = dev[mode] / r["med"]["step"]
        out["dds"][mode] = dict(s_per_image=per_image, ms_step=r["med"]["step"], busy_max=share,
                                busy_profiled=prof_share[mode])
        log(f"  DDS {SHARD_DDS_STEPS} steps, {1 if mode == 'serial' else n} image(s) per call: "
            f"{per_image:.3f} s per image in the sampler ({r['wall_s']:.1f} s in the CLI for "
            f"{images_of[mode]}); per step (CUDA events, median of the last steps) "
            f"{r['med']['step']:.2f} ms = UNet {r['med']['unet']:.2f} ms + CG(5) "
            f"{r['med']['cg']:.2f} ms + rest {r['med']['rest']:.2f} ms; device busy: graph-replay "
            f"UNet + CG {dev[mode]:.2f} ms is at most {share:.1%} of the step, a torch.profiler "
            f"trace of {SHARD_TRACE_DDS_STEPS} steps (union of the device events over the wall "
            "time) "
            + ("holds no device time" if prof_share[mode] is None
               else f"{prof_share[mode]:.1%} busy"))
    log(f"  seconds per image: {out['dds']['serial']['s_per_image']:.2f} at 1 image per call, "
        f"{out['dds']['batched']['s_per_image']:.2f} at {n}; launches batched "
        + json.dumps(runs["batched"]["counts"]))
    out["dds_counts"] = runs["batched"]["counts"]
    # phase 14 holds its sharded run to these
    out["one_card"] = {"dds_psnr": [r[0] for r in rows_out], "dds_fbp": [r[2] for r in rows_out],
                       "dds_s_per_image": out["dds"]["batched"]["s_per_image"]}
    log(f"[phase 11b conditional, {n} images] {time.perf_counter() - t0:.1f} s")

    # ---- 11c. adapted lora: the batched gradient for two images, then the CLI
    t0 = time.perf_counter()
    m16, m32, obs2, x2 = batched_gradient_check(F, config, config32, sde, trafo, images, gen)
    tc0 = time.perf_counter()
    out["chain_errs"] = batched_chain_check(F, m32, sde, trafo, obs2, gen)
    del m32
    log(f"  (the batched gradient and the fp32 chain: {tc0 - t0:.1f} s and "
        f"{time.perf_counter() - tc0:.1f} s)")
    # device time of one Adam step's forward and backward at n images (graph replay)
    smp = F.get_standard_adapted_sampler("dds", m16, sde, trafo, obs2[0], num_steps=50,
                                         lora_rank=LORA_RANK, add_cg=True, cg_iter=1)
    m16.requires_grad_(False)
    imgs4 = smp.batched_inputs(torch.cat([torch.stack(obs2)] * (n // 2)), None)
    leaves4 = list(imgs4.leaves.values())
    x4a = torch.cat([x2] * (n // 2))
    both4_dev = time_ms(lambda: torch.autograd.grad(
        smp.adaptation_loss(x4a, t4, images=imgs4), leaves4), 3)
    del imgs4, leaves4, smp
    base = ["--load_path", CKPT, "--num_channels", "128", "--dtype", "bfloat16", "--adaptation",
            "lora", "--num_steps", str(SHARD_ADAPT_STEPS), "--num_optim_step",
            str(SHARD_ADAPT_OPTIM), "--add_cg"]
    runs = {}
    for mode, argv in (("batched", base + ["--num_images", str(n), "--shard_images", str(n)]),
                       ("serial", base + ["--num_images", str(k)])):
        made = []

        def wrap(make):
            def mk(*a, **k):
                s_ = make(*a, **k)
                made.append((AdaptTimer(s_), CallTimer(s_, ["sample", "sample_batched"])))
                return s_
            return mk

        resident = torch.cuda.memory_allocated()        # the models this script holds
        torch.cuda.reset_peak_memory_stats()
        root, wall_s, counts, report = run_cli(ACLI, argv, os.path.join(workdir, "a" + mode),
                                               (F, "get_standard_adapted_sampler", wrap))
        peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        rows = [r for timer, _ in made for r in timer.split()]
        med = {k: float(np.median([r[k] for r in rows]))
               for k in ("step", "adapt", "fwd_adapted", "fwd_prior", "rest")}
        sample_s = sum(sum(c.seconds.values()) for _, c in made)
        recs = []
        for i in range(images_of[mode]):
            with np.load(os.path.join(root, f"recon_{i}_info.npz")) as info:
                recs.append((info["recon"], info["ground_truth"]))
        runs[mode] = dict(wall_s=wall_s, counts=counts, med=med, sample_s=sample_s, recs=recs,
                          peak=peak)
        chains = 1 if mode == "batched" else k
        check_counts(counts, chains * (SHARD_ADAPT_STEPS * (SHARD_ADAPT_OPTIM + 2) + 1),
                     chains * SHARD_ADAPT_STEPS * SHARD_ADAPT_OPTIM,
                     f"adapted lora through the CLI, {mode}")
    for i in range(k):
        (rb, g_np), (rs, g_s) = runs["batched"]["recs"][i], runs["serial"]["recs"][i]
        if not (np.array_equal(g_np, g_s) and rb.shape == (256, 256) and np.isfinite(rb).all()):
            raise AssertionError(f"adapted image {i}: batched and serial differ in their image, or "
                                 "the batched reconstruction is not finite")
        g = torch.Generator(device="cuda").manual_seed(config.seed * 1000 + i)
        _, _, fbp = F.get_data_from_ground_truth(g_np[..., None], trafo, config.data.stddev,
                                                 generator=g)
        f_np = fbp[0, ..., 0].cpu().numpy()
        pb, ps, pf = PSNR(rb, g_np), PSNR(rs, g_np), PSNR(f_np, g_np)
        log(f"  test-fold image {i}: adapted lora {SHARD_ADAPT_STEPS} x {SHARD_ADAPT_OPTIM} batched "
            f"({n} per call) {pb:.2f} dB | serial {ps:.2f} dB | FBP {pf:.2f} dB (a cut run that "
            "does not reconstruct: PSNR against FBP not gated; the fp32 chain above holds batched "
            "to serial by tensors)")
        if abs(pb - ps) > SHARD_ADAPT_AGREE_DB:
            raise AssertionError(f"adapted image {i}: batched {pb:.2f} dB and serial {ps:.2f} dB "
                                 f"differ by more than {SHARD_ADAPT_AGREE_DB} dB")
    # the device's busy share from profiler traces of SHARD_TRACE_STEPS outer
    # steps at 1 and at n images (the CLI's settings, the shapes warm)
    prof_share, tc0 = {}, time.perf_counter()
    smp = F.get_standard_adapted_sampler("dds", m16, sde, trafo, obs2[0],
                                         num_steps=SHARD_ADAPT_STEPS, num_optim_step=SHARD_ADAPT_OPTIM,
                                         lora_rank=LORA_RANK, add_cg=True, cg_iter=1)
    smp._time_data = tuple(a[:SHARD_TRACE_STEPS] if isinstance(a, np.ndarray) else a
                           for a in smp._time_data)
    obs4 = torch.cat([torch.stack(obs2)] * (n // 2))
    for mode, call in (("serial", lambda: smp.sample(generator=gen)),
                       ("batched", lambda: smp.sample_batched(obs4, generator=gen))):
        prof_share[mode] = busy_share_profiled(call, os.path.join(workdir, "trace_adapted_" + mode))
    del smp
    log(f"  (the adapted runs' profiler traces: {time.perf_counter() - tc0:.1f} s)")
    out["adapted"] = {}
    for mode in ("serial", "batched"):
        r = runs[mode]
        per_image = r["sample_s"] / images_of[mode]
        dev_step = (SHARD_ADAPT_OPTIM * (dev_times["adapt_both"] if mode == "serial" else both4_dev)
                    + 2 * (dev_times["fwd"] if mode == "serial" else fwd4_dev))
        share = dev_step / r["med"]["step"]
        out["adapted"][mode] = dict(s_per_image=per_image, ms_step=r["med"]["step"],
                                    busy_max=share, busy_profiled=prof_share[mode],
                                    peak_gib=r["peak"])
        log(f"  adapted {SHARD_ADAPT_STEPS} x {SHARD_ADAPT_OPTIM}, {1 if mode == 'serial' else n} "
            f"image(s) per call: {per_image:.3f} s per image in the sampler ({r['wall_s']:.1f} s in "
            f"the CLI for {images_of[mode]}); per outer step (median) {r['med']['step']:.1f} ms = "
            f"adaptation {r['med']['adapt']:.1f} ms + adapted forward {r['med']['fwd_adapted']:.2f} "
            f"ms + prior forward {r['med']['fwd_prior']:.2f} ms + rest {r['med']['rest']:.2f} ms; "
            f"device busy at most {share:.1%} (graph replay: {SHARD_ADAPT_OPTIM} x forward + "
            f"backward + 2 forwards = {dev_step:.1f} ms), a torch.profiler trace of "
            f"{SHARD_TRACE_STEPS} outer steps "
            + ("holds no device time" if prof_share[mode] is None
               else f"{prof_share[mode]:.1%} busy")
            + f"; peak memory {r['peak']:.2f} GiB above what the script held before")
    log(f"  seconds per image: {out['adapted']['serial']['s_per_image']:.2f} at 1 image per call, "
        f"{out['adapted']['batched']['s_per_image']:.2f} at {n}; device forward + backward of the "
        f"loss at {n} images {both4_dev:.2f} ms against {dev_times['adapt_both']:.2f} ms at 1; "
        "launches batched " + json.dumps(runs["batched"]["counts"]))
    out["adapted_counts"] = runs["batched"]["counts"]
    out["one_card"].update(
        adapted_psnr=[float(PSNR(rb, g_np)) for rb, g_np in runs["batched"]["recs"]],
        adapted_s_per_image=out["adapted"]["batched"]["s_per_image"])
    del m16
    log(f"[phase 11c adapted lora, {n} images] {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 14: the multi-card paths, one process per rank (parallel/launch.py)
MC_RANKS = 2                  # ranks of the phase: one per card, or two on the one card
MC_TRAIN_BATCH = 6            # the train CLI's global batch (3 rows a rank)
MC_TRAIN_STEPS = 4
# each sharded step's loss (the mean over the ranks) against the one-process
# loss at batch 6 on the same parameters, t and z: both bf16 compute, whose
# conv plans change with the batch (split-K), so that last bf16 bits differ;
# the gradient over all leaves is held to phase 9's TOL_GRAD_ALL.  Set before
# the first run (PERF.md §6)
MC_LOSS_RTOL = 5e-3
MC_DDS_AGREE_DB = 1.0         # each sharded DDS image against phase 11b's one-card batch-4 run
MC_CHAIN_IMAGES = 2           # the fp32 chains held to the one-process chain by tensors
MC_DDS_CHAIN_STEPS = 4
MC_TRACE_DDS_STEPS = 10       # the profiled DDS steps per rank (busy share)
# phase 14 alone (`--phase14`): the one-card batch-4 runs it is held to
# otherwise come from phase 11


def mc_layout():
    """(devices, backend, what): one rank per card over NCCL where there are
    several cards, else two ranks on the one card over gloo (NCCL refuses
    two ranks on one card)."""
    import torch

    if torch.cuda.device_count() > 1:
        return ([f"cuda:{i}" for i in range(MC_RANKS)], "nccl",
                f"{MC_RANKS} ranks, one per card, over NCCL")
    return (["cuda:0"] * MC_RANKS, "gloo",
            f"{MC_RANKS} ranks sharing the one card (cuda:0) over gloo: NCCL is not run")


def _gather_objects(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _counts_of(fn):
    """fn() with the launch counters left as they were (a comparison run)."""
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    saved = {m: {k: (dict(v) if isinstance(v, dict) else v) for k, v in vars(m).items()
                 if k.startswith(("launches", "backward_launches", "wgrad_launches"))}
             for m in (A, C)}
    try:
        return fn()
    finally:
        for m, kv in saved.items():
            for k, v in kv.items():
                setattr(m, k, v)


def _replicas_equal(params, mesh):
    """Whether every rank's parameters equal rank 0's, bit for bit."""
    import torch
    import torch.distributed as dist

    bits = torch.cat([p.detach().reshape(-1) for p in params]).view(torch.int32)
    ref = bits.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    flag = torch.tensor([int(torch.equal(bits, ref))], device=bits.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


def _mc_train(plan, mesh):
    """14a in a rank: the train CLI, data-parallel; per step the replicas
    compared bitwise, and (rank 0) the step's loss and all-reduced
    gradient against the one-process step at the global batch."""
    import torch

    from diffusion_models_dev_project_tpu_torch import run_score_based_models_train as TRAIN_CLI
    from diffusion_models_dev_project_tpu_torch.parallel.mesh import gather_batch
    from diffusion_models_dev_project_tpu_torch.training import losses as L
    from diffusion_models_dev_project_tpu_torch.training import trainer as T

    rows, make_step, reduce_ = [], T.make_train_step, T.all_reduce_mean_
    reduced = []

    def capturing_reduce(m, tensors):
        reduce_(m, tensors)
        if mesh.rank == 0:                       # the step's all-reduced gradients
            reduced.append([g.detach().clone() for g in tensors[:-1]])

    def checked_make_train_step(model_apply, sde, optimizer, *a, **k):
        step = make_step(model_apply, sde, optimizer, *a, **k)
        names = list(optimizer.params)

        def checked(state, batch, generator=None, t=None, z=None):
            row = {}
            if mesh.rank == 0:
                gb, gt_, gz = (gather_batch(mesh, v) for v in (batch, t, z))

                def reference():
                    with torch.enable_grad():
                        loss = L.score_matching_loss(gb, model_apply, sde, t=gt_, z=gz)
                        g = torch.autograd.grad(loss, [optimizer.params[n] for n in names])
                    return float(loss.detach()), g
                row["loss_ref"], g_ref = _counts_of(reference)
            else:
                for v in (batch, t, z):
                    gather_batch(mesh, v)
            e0 = StepTimer._event()
            loss = step(state, batch, t=t, z=z)
            e1 = StepTimer._event()
            torch.cuda.synchronize()
            row["ms"] = e0.elapsed_time(e1)
            row["loss"] = float(loss)
            if mesh.rank == 0:
                got = reduced.pop()
                num = sum(float(torch.linalg.vector_norm((a - b).double()) ** 2)
                          for a, b in zip(got, g_ref))
                den = sum(float(torch.linalg.vector_norm(b.double()) ** 2) for b in g_ref)
                row["grad_err"] = math.sqrt(num / den)
                del got, g_ref
            row["replicas_equal"] = _replicas_equal(optimizer.params.values(), mesh)
            rows.append(row)
            return loss
        return checked

    workdir = os.path.join(plan["workdir"], "train")
    argv = ["--num_channels", "128", "--dtype", "bfloat16", "--batch_size", str(MC_TRAIN_BATCH),
            "--epochs", "1", "--steps_per_epoch", str(MC_TRAIN_STEPS), "--init_ckpt", CKPT,
            "--lr_warmup", str(TRAIN_WARMUP), "--base_path", workdir]
    T.make_train_step, T.all_reduce_mean_ = checked_make_train_step, capturing_reduce
    try:
        torch.cuda.synchronize()
        reset_counts()
        ts = time.perf_counter()
        result = TRAIN_CLI.coordinator(TRAIN_CLI.parser.parse_args(argv))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - ts
        counts = read_counts()
    finally:
        T.make_train_step, T.all_reduce_mean_ = make_step, reduce_
    saved = os.path.isfile(os.path.join(result["log_dir"], "ckpts", str(MC_TRAIN_STEPS),
                                        "state.pt")) if mesh.rank == 0 else None
    return dict(rows=rows, counts=counts, wall_s=wall_s, step=result["step"], saved=saved)


def _mc_cli(module, argv, workdir, patch=None):
    """run_cli's measurements in a rank: the CLI runs in this rank's group;
    (output directory, wall seconds, counts, report) on rank 0, the report
    None elsewhere."""
    import torch
    import torch.distributed as dist

    cwd = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    orig = None
    if patch is not None:
        mod, name, wrap = patch
        orig = getattr(mod, name)
        setattr(mod, name, wrap(orig))
    try:
        dist.barrier()
        torch.cuda.synchronize()
        reset_counts()
        ts = time.perf_counter()
        root = module.coordinator(module.parser.parse_args(argv))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - ts
        counts = read_counts()
    finally:
        if orig is not None:
            setattr(patch[0], patch[1], orig)
        os.chdir(cwd)
    if dist.get_rank() != 0:
        return None, wall_s, counts, None
    root = os.path.join(workdir, root)
    return root, wall_s, counts, read_report(os.path.join(root, "report.yaml"))


def _mc_sampling(plan, mesh):
    """14b and 14c in a rank: the conditional and the adapted CLI sharded,
    then the fp32 chains, sharded against one process, and profiled steps."""
    import torch
    import torch.distributed as dist

    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch import run_adapted_sampling as ACLI
    from diffusion_models_dev_project_tpu_torch import run_conditional_sampling as CLI
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import init_lora
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR

    n = SHARD_IMAGES
    out = {}
    config = get_config("vesde")
    config.model.num_channels = 128
    config.model.dtype = "bfloat16"
    config.data.part = "val"
    config32 = copy.deepcopy(config)
    config32.model.dtype = "float32"
    sde = F.get_standard_sde(config)
    trafo = F.get_standard_ray_trafo(config)
    images = np.load(VALSET)["images"]
    gen = torch.Generator(device="cuda").manual_seed(14)         # alike on every rank
    obs2 = []
    for j in range(MC_CHAIN_IMAGES):
        g = torch.Generator(device="cuda").manual_seed(config.seed + j)
        obs2.append(F.get_data_from_ground_truth(images[j], trafo, config.data.stddev,
                                                 generator=g)[1])

    # ---- 14b. the conditional CLI, its chunk of n images sharded over the ranks
    timers = []

    def wrap(make):
        def made(*a, **k):
            smp = make(*a, **k)
            timers.append(CallTimer(smp, ["sample"]))
            return smp
        return made

    argv = ["--load_path", CKPT, "--num_channels", "128", "--method", "dds", "--eta", "0.85",
            "--num_steps", str(SHARD_DDS_STEPS), "--num_images", str(n), "--shard_images", str(n)]
    root, wall_s, counts, report = _mc_cli(CLI, argv, os.path.join(plan["workdir"], "dds"),
                                           (F, "get_standard_sampler", wrap))
    out["dds"] = dict(wall_s=wall_s, counts=counts, sample_s=timers[0].seconds["sample"],
                      report=report, psnr=None)
    if mesh.rank == 0:
        psnr = []
        for i in range(n):
            with np.load(os.path.join(root, f"recon_{i}_info.npz")) as info:
                psnr.append(float(PSNR(info["recon"], info["ground_truth"])))
        out["dds"]["psnr"] = psnr
    # the fp32 chain: MC_CHAIN_IMAGES images x MC_DDS_CHAIN_STEPS, sharded, against one process
    m32, _, score32 = F.get_standard_score(config32, sde, ckpt_path=CKPT)
    smp = F.get_standard_sampler("dds", score32, sde, trafo, torch.cat(obs2),
                                 num_steps=MC_DDS_CHAIN_STEPS, batch_size=MC_CHAIN_IMAGES,
                                 im_shape=(256, 256, 1), eta=0.85, gamma=0.01, cg_iter=5)
    noises = [torch.randn((MC_CHAIN_IMAGES, 256, 256, 1), generator=gen, device="cuda")
              for _ in range(smp.num_draws)]
    x_sh, _ = smp.sample(noises=noises, mesh=mesh)
    if mesh.rank == 0:
        x_one, _ = smp.sample(noises=noises)
        out["dds_chain_err"] = float((x_sh - x_one).abs().max() / x_one.abs().max())
        out["dds_chain_finite"] = bool(torch.isfinite(x_sh).all())
    del m32, score32, smp
    # busy share per rank: MC_TRACE_DDS_STEPS steps of the sharded chain, both ranks at once
    model, _, score = F.get_standard_score(config, sde, ckpt_path=CKPT)
    obs4 = torch.cat([torch.cat(obs2)] * (n // MC_CHAIN_IMAGES))
    smp = F.get_standard_sampler("dds", score, sde, trafo, obs4, num_steps=SHARD_DDS_STEPS,
                                 batch_size=n, im_shape=(256, 256, 1), gamma=0.01, eta=0.85,
                                 cg_iter=5)
    smp._time_data = tuple(a[-MC_TRACE_DDS_STEPS:] if isinstance(a, np.ndarray) else a
                           for a in smp._time_data)
    dist.barrier()
    out["dds_busy"] = busy_share_profiled(lambda: smp.sample(generator=gen, mesh=mesh),
                                          os.path.join(plan["workdir"], f"trace_dds_{mesh.rank}"))
    del model, score, smp

    # ---- 14c. the adapted CLI (lora), its chunk of n images split over the ranks
    made = []

    def wrap_a(make):
        def mk(*a, **k):
            s_ = make(*a, **k)
            made.append(CallTimer(s_, ["sample_batched"]))
            return s_
        return mk

    argv = ["--load_path", CKPT, "--num_channels", "128", "--dtype", "bfloat16", "--adaptation",
            "lora", "--num_steps", str(SHARD_ADAPT_STEPS), "--num_optim_step",
            str(SHARD_ADAPT_OPTIM), "--add_cg", "--num_images", str(n), "--shard_images", str(n)]
    root, wall_s, counts, report = _mc_cli(ACLI, argv, os.path.join(plan["workdir"], "adapted"),
                                           (F, "get_standard_adapted_sampler", wrap_a))
    out["adapted"] = dict(wall_s=wall_s, counts=counts,
                          sample_s=sum(c.seconds["sample_batched"] for c in made),
                          report=report, psnr=None)
    if mesh.rank == 0:
        psnr = []
        for i in range(n):
            with np.load(os.path.join(root, f"recon_{i}_info.npz")) as info:
                psnr.append(float(PSNR(info["recon"], info["ground_truth"])))
        out["adapted"]["psnr"] = psnr
    # the fp32 chain (phase 11c's): MC_CHAIN_IMAGES images, own LoRA states and draws
    m32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
    smp = F.get_standard_adapted_sampler(
        "dds", m32, sde, trafo, obs2[0], num_steps=SHARD_CHAIN_STEPS, eta=0.85, gamma=0.01,
        tv_penalty=1e-6, lr=1e-3, num_optim_step=SHARD_CHAIN_OPTIM, adapt_freq=1,
        lora_rank=LORA_RANK, add_cg=True, dc_type="cg", cg_iter=1)
    loras = [init_lora(m32, seed=j) for j in range(MC_CHAIN_IMAGES)]
    stack = {k: torch.stack([lo[k] for lo in loras]) for k in loras[0]}
    noises = [[torch.randn((1, 256, 256, 1), generator=gen, device="cuda")
               for _ in range(smp.num_draws)] for _ in range(MC_CHAIN_IMAGES)]
    xb_sh = smp.sample_batched(torch.stack(obs2), noises=noises, lora_stack=stack, mesh=mesh)
    if mesh.rank == 0:
        xb_one = smp.sample_batched(torch.stack(obs2), noises=noises, lora_stack=stack)
        out["adapted_chain_err"] = float((xb_sh - xb_one).abs().max() / xb_one.abs().max())
        out["adapted_chain_finite"] = bool(torch.isfinite(xb_sh).all())
    del m32, smp
    # busy share per rank: SHARD_TRACE_STEPS outer steps of the sharded lora chain
    m16, _, _ = F.get_standard_score(config, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
    smp = F.get_standard_adapted_sampler("dds", m16, sde, trafo, obs2[0],
                                         num_steps=SHARD_ADAPT_STEPS,
                                         num_optim_step=SHARD_ADAPT_OPTIM, lora_rank=LORA_RANK,
                                         add_cg=True, cg_iter=1)
    smp._time_data = tuple(a[:SHARD_TRACE_STEPS] if isinstance(a, np.ndarray) else a
                           for a in smp._time_data)
    dist.barrier()
    out["adapted_busy"] = busy_share_profiled(
        lambda: smp.sample_batched(obs4.reshape(n, 1, *obs4.shape[1:]), generator=gen, mesh=mesh),
        os.path.join(plan["workdir"], f"trace_adapted_{mesh.rank}"))
    return out


def multicard_rank(plan):
    """Phase 14 in one rank (`parallel/launch.py::launch`); rank 0 returns
    every rank's results, in rank order."""
    import torch

    from diffusion_models_dev_project_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    t0 = time.perf_counter()
    res = {"rank": mesh.rank, "device": str(mesh.device),
           "name": torch.cuda.get_device_name(mesh.device)}
    res["train"] = _mc_train(plan, mesh)
    res["train_s"] = time.perf_counter() - t0
    res.update(_mc_sampling(plan, mesh))
    res["seconds"] = time.perf_counter() - t0
    return _gather_objects(res)


def one_card_batched(F, CLI, ACLI, config, trafo, workdir):
    """Phase 14 alone: phase 11's one-card batch-4 runs through both CLIs
    (DDS and adapted lora, the same flags), with the images' PSNR, their
    FBP's and the seconds per image."""
    import torch

    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR

    n, out = SHARD_IMAGES, {}
    for key, module, make, method, argv in (
            ("dds", CLI, "get_standard_sampler", "sample",
             ["--method", "dds", "--eta", "0.85", "--num_steps", str(SHARD_DDS_STEPS)]),
            ("adapted", ACLI, "get_standard_adapted_sampler", "sample_batched",
             ["--dtype", "bfloat16", "--adaptation", "lora", "--num_steps", str(SHARD_ADAPT_STEPS),
              "--num_optim_step", str(SHARD_ADAPT_OPTIM), "--add_cg"])):
        timers = []

        def wrap(mk, method=method):
            def made(*a, **k):
                smp = mk(*a, **k)
                timers.append(CallTimer(smp, [method]))
                return smp
            return made

        root, _, _, _ = run_cli(module, ["--load_path", CKPT, "--num_channels", "128",
                                         "--num_images", str(n), "--shard_images", str(n)] + argv,
                                os.path.join(workdir, key), (F, make, wrap))
        psnr, fbp = [], []
        for i in range(n):
            with np.load(os.path.join(root, f"recon_{i}_info.npz")) as info:
                recon, g_np = info["recon"], info["ground_truth"]
            psnr.append(float(PSNR(recon, g_np)))
            g = torch.Generator(device="cuda").manual_seed(config.seed * 1000 + i)
            f = F.get_data_from_ground_truth(g_np[..., None], trafo, config.data.stddev,
                                             generator=g)[2]
            fbp.append(float(PSNR(f[0, ..., 0].cpu().numpy(), g_np)))
        out[f"{key}_psnr"] = psnr
        out[f"{key}_s_per_image"] = sum(t.seconds[method] for t in timers) / n
        if key == "dds":
            out["dds_fbp"] = fbp
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def multicard_phase(one_card, workdir):
    """Phase 14: the three multi-card paths through their CLIs, sharded over
    `MC_RANKS` ranks (`mc_layout`), every gate checked here on rank 0's
    report of every rank.  `one_card`: phase 11's batch-4 one-card results
    (per-image DDS PSNR and FBP, seconds per image)."""
    from diffusion_models_dev_project_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    devices, backend, what = mc_layout()
    log(f"  layout: {what}; backend {backend}, devices {devices}")
    shutil.rmtree(workdir, ignore_errors=True)
    ranks = launch(multicard_rank, devices, backend, {"workdir": workdir})
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    n = SHARD_IMAGES
    log(f"  ranks: " + ", ".join(f"rank {r['rank']} on {r['device']} ({r['name']}) "
                                 f"{r['seconds']:.1f} s of work" for r in ranks)
        + f"; {spawn_s:.1f} s in launch")

    # ---- 14a
    # per rank and step one forward and one backward at its rows, every
    # parameter training (phase 9's pattern: 62 weight and 61 input gradients)
    s = MC_TRAIN_STEPS
    want = {"conv_fwd": 62 * s, "attn_fwd": 4 * s, "conv_wgrad": 62 * s, "conv_bwd": 61 * s,
            "attn_bwd": 4 * s}
    for r in ranks:
        tr = r["train"]
        if {k: tr["counts"][k] for k in want} != want:
            raise AssertionError(f"rank {r['rank']}'s data-parallel training run: launch counts "
                                 f"{tr['counts']}, want {want}")
        if not all(row["replicas_equal"] for row in tr["rows"]) or len(tr["rows"]) != MC_TRAIN_STEPS:
            raise AssertionError(f"rank {r['rank']}: the replicas differ after a step: "
                                 f"{[row['replicas_equal'] for row in tr['rows']]}")
    rows = r0["train"]["rows"]
    log(f"  14a train CLI, batch {MC_TRAIN_BATCH} over {MC_RANKS} ranks ({MC_TRAIN_BATCH // MC_RANKS} "
        f"rows a rank), {MC_TRAIN_STEPS} steps warm-started from {os.path.relpath(CKPT, REPO)}: "
        "per step loss (mean over ranks) / one-process loss at the global batch, gradient over all "
        "leaves against the one-process step's: "
        + "; ".join(f"{row['loss']:.6e} / {row['loss_ref']:.6e} ({abs(row['loss'] / row['loss_ref'] - 1):.2e}), "
                    f"{row['grad_err']:.3e}" for row in rows)
        + f" (tol {MC_LOSS_RTOL:g}, {TOL_GRAD_ALL:g}); replicas bitwise equal after every step; "
        "ms per step (CUDA events) " + " | ".join(
            f"rank {r['rank']} " + ", ".join(f"{row['ms']:.1f}" for row in r["train"]["rows"])
            for r in ranks)
        + f"; the CLI {r0['train']['wall_s']:.1f} s; checkpoint saved by rank 0: {r0['train']['saved']}")
    for row in rows:
        if not (math.isfinite(row["loss"]) and abs(row["loss"] / row["loss_ref"] - 1) <= MC_LOSS_RTOL
                and row["grad_err"] <= TOL_GRAD_ALL):
            raise AssertionError(f"a data-parallel step differs from the one-process step: {row}")
    if not (r0["train"]["saved"] and r0["train"]["step"] == MC_TRAIN_STEPS):
        raise AssertionError("the data-parallel run saved no checkpoint at its last step")

    # ---- 14b
    dds = r0["dds"]
    for r in ranks:
        check_counts(r["dds"]["counts"], SHARD_DDS_STEPS, 0,
                     f"rank {r['rank']}'s share of the sharded DDS through the CLI")
    if dds["report"]["diverged_images"] != "[]":
        raise AssertionError(f"sharded DDS diverged: {dds['report']['diverged_images']}")
    for i in range(n):
        pb, pf, p1 = dds["psnr"][i], one_card["dds_fbp"][i], one_card["dds_psnr"][i]
        log(f"  14b test-fold image {i}: DDS sharded over {MC_RANKS} ranks {pb:.2f} dB | one card, "
            f"batch {n} (phase 11b) {p1:.2f} dB | FBP {pf:.2f} dB")
        if not (pb > pf and abs(pb - p1) <= MC_DDS_AGREE_DB):
            raise AssertionError(f"image {i}: sharded DDS {pb:.2f} dB against FBP {pf:.2f} dB and "
                                 f"the one-card run's {p1:.2f} dB (within {MC_DDS_AGREE_DB} dB)")
    log(f"  14b fp32 DDS chain, {MC_CHAIN_IMAGES} images x {MC_DDS_CHAIN_STEPS} steps, injected "
        f"draws, sharded against one process: max|diff| / max|x| {r0['dds_chain_err']:.3e} "
        f"(tol {TOL_SHARD_CHAIN:g})")
    if not (r0["dds_chain_finite"] and r0["dds_chain_err"] <= TOL_SHARD_CHAIN):
        raise AssertionError(f"the sharded fp32 DDS chain differs: {r0['dds_chain_err']}")

    # ---- 14c
    adapted = r0["adapted"]
    chain = SHARD_ADAPT_STEPS * (SHARD_ADAPT_OPTIM + 2) + 1
    for r in ranks:
        check_counts(r["adapted"]["counts"], chain, SHARD_ADAPT_STEPS * SHARD_ADAPT_OPTIM,
                     f"rank {r['rank']}'s share of the sharded adapted run through the CLI")
    log("  14c adapted lora " + f"{SHARD_ADAPT_STEPS} x {SHARD_ADAPT_OPTIM}, {n} images over "
        f"{MC_RANKS} ranks (PSNR printed, not gated: the cut run does not reconstruct): "
        + ", ".join(f"image {i} {p:.2f} dB (one card {q:.2f})" for i, (p, q) in
                    enumerate(zip(adapted["psnr"], one_card["adapted_psnr"]))))
    log(f"  14c fp32 adapted chain (lora, {MC_CHAIN_IMAGES} images, {SHARD_CHAIN_STEPS} x "
        f"{SHARD_CHAIN_OPTIM}, own LoRA states, injected draws), sharded against one process: "
        f"max|diff| / max|x| {r0['adapted_chain_err']:.3e} (tol {TOL_SHARD_CHAIN:g})")
    if not (r0["adapted_chain_finite"] and r0["adapted_chain_err"] <= TOL_SHARD_CHAIN):
        raise AssertionError(f"the sharded fp32 adapted chain differs: {r0['adapted_chain_err']}")

    # ---- what it prints
    summed = {}
    for r in ranks:
        for part in ("train", "dds", "adapted"):
            for k in ("conv_fwd", "conv_bwd", "conv_wgrad", "attn_fwd", "attn_bwd"):
                summed[k] = summed.get(k, 0) + r[part]["counts"][k]
    out = {"layout": what, "backend": backend, "launches": summed,
           "dds_s_per_image": {1: one_card["dds_s_per_image"], MC_RANKS: dds["sample_s"] / n},
           "adapted_s_per_image": {1: one_card["adapted_s_per_image"],
                                   MC_RANKS: adapted["sample_s"] / n},
           "busy": {r["rank"]: (r["dds_busy"], r["adapted_busy"]) for r in ranks}}
    log(f"  seconds per image, {n} images per call ({what}): DDS {SHARD_DDS_STEPS} steps "
        f"{out['dds_s_per_image'][1]:.3f} at 1 rank (phase 11b), {out['dds_s_per_image'][MC_RANKS]:.3f} "
        f"at {MC_RANKS}; adapted lora {SHARD_ADAPT_STEPS} x {SHARD_ADAPT_OPTIM} "
        f"{out['adapted_s_per_image'][1]:.3f} at 1 rank (phase 11c), "
        f"{out['adapted_s_per_image'][MC_RANKS]:.3f} at {MC_RANKS}"
        + ("" if backend == "nccl" else " (two host processes feeding one card, not a multi-card "
           "speed-up)"))
    log("  device busy per rank (torch.profiler, union of the rank's device events over its wall "
        f"time; DDS {MC_TRACE_DDS_STEPS} steps, adapted {SHARD_TRACE_STEPS} outer step): "
        + ", ".join(f"rank {k} DDS " + ("no device time" if d is None else f"{d:.1%}")
                    + " adapted " + ("no device time" if a is None else f"{a:.1%}")
                    for k, (d, a) in out["busy"].items()))
    log("  launches in phase 14's runs, per rank summed: " + json.dumps(summed))
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"[phase 14 multi-card] {time.perf_counter() - t0:.1f} s")
    return out


# ---- phases 12, 12b and 13: the walnut protocol, AAPM and the matrix operator
# The walnut protocol's geometry and phantom are the port's
# `scripts/_walnut_common.py` (the CWI scanner's magnification on a synthetic
# centred orbit, 60 angles x 128 columns, the centre slice of a 9-slice slab)
WALNUT_STDDEV = 0.05          # walnut_configs: relative noise of the observation
WALNUT_GAMMA, WALNUT_ETA = 0.01, 0.85
WALNUT_STEPS = 1000           # DDS steps of the walnut runs (the protocol's)
# each walnut DDS (cg and woodbury) must beat FDK by this much (dB): about half
# the smaller margin of a probe of both runs (11.55 dB, walnut_probe.py), set
# before the full run (PERF.md §6)
WALNUT_MARGIN_DB = 5.5
# the Woodbury run must reconstruct what the CG(5) run does, through the
# engine's own path (S⁻¹ and the observation in `dds_step`): the two agreed to
# 0.01-0.02 dB in every run of PR 12 (walnut_probe.py and chip_smoke.py; PERF.md §6)
WALNUT_AGREE_DB = 0.5
NATIVE_CHECK_RAYS = 256       # masked rays held to the plain assembly
TOL_NATIVE = dict(rtol=1e-5, atol=1e-6)   # as tests/test_native.py
TOL_WALNUT_ELL = 1e-5         # |A_ell x - A_dense x| / |A_ell x| at the model grid
TOL_WALNUT_ADJ = 1e-5         # |<Ax, y> - <x, Aᵀy>| / |<Ax, y>| of the dense operator
TOL_WOODBURY = 1e-4           # |(I + γAᵀA)x - (x̂₀ + γAᵀy)| / |x̂₀ + γAᵀy|
# the entry points' FDK (dB) against this phase's: the same operator, seed and calls
TOL_WALNUT_FDK = 1e-6
WALNUT_ADAPT_STEPS, WALNUT_ADAPT_OPTIM = 5, 3    # the adapted walnut run, cut
AAPM_SLICES = 24              # scripts/make_synth_aapm.py --n
# DDS steps of the AAPM runs (protocol 1000), cut to keep the whole run inside
# its time limit (PERF.md §4)
AAPM_STEPS = 100


def psnr_ssim(x, gt, clamp=True):
    """(PSNR, SSIM) of the first image of NHWC `x` against `gt`, clamped at 0
    as the CLIs clamp a reconstruction (FBP and FDK: `clamp=False`)."""
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR, SSIM

    r = x[0, ..., 0].float().cpu().numpy()
    g = gt[0, ..., 0].float().cpu().numpy()
    if not np.isfinite(r).all():
        raise AssertionError("reconstruction not finite")
    if clamp:
        r = np.clip(r, 0, None)
    return PSNR(r, g), SSIM(r, g)


def timed_dds(F, P, score_fn, sde, trafo, obs, steps, dc_mode, generator, what):
    """A DDS run of `steps` steps at gamma 0.01, eta 0.85, cg_iter 5 with
    CUDA events splitting its last steps into UNet, data consistency and
    rest; exact launch counts.  Returns (x, counts, ms per step, medians)."""
    import torch

    name = "cg" if dc_mode == "cg" else "woodbury_dc"
    timer = StepTimer(score_fn, getattr(P, name), first_step=max(steps - SPLIT_STEPS, 0))
    sampler = F.get_standard_sampler("dds", timer.score, sde, trafo, obs, num_steps=steps,
                                     im_shape=(256, 256, 1), gamma=WALNUT_GAMMA, eta=WALNUT_ETA,
                                     cg_iter=5, dc_mode=dc_mode)
    torch.cuda.synchronize()
    original = getattr(P, name)
    setattr(P, name, timer.cg)        # the sampler's data consistency, between CUDA events
    try:
        reset_counts()
        ts = time.perf_counter()
        x, _ = sampler.sample(generator=generator)
        timer.finish()
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - ts) / steps * 1e3
        counts = read_counts()
    finally:
        setattr(P, name, original)
    check_counts(counts, steps, 0, what)
    rows = timer.split()
    med = {k: float(np.median([r[k] for r in rows])) for k in ("step", "unet", "cg", "rest")}
    if x.shape != (1, 256, 256, 1) or min(min(r.values()) for r in rows) < 0:
        raise AssertionError(f"{what}: wrong shape or a part of a step timed negative")
    return x, counts, ms_step, med


def walnut_phase(F, P, model_args, steps, gen, gate=True):
    """Phases 12 and 12b: the walnut cone-beam protocol at full scale (see
    the module's docstring).  `model_args` = (config, config32, sde,
    score_fn); returns the numbers the summary and PERF.md read."""
    import tempfile

    import scipy.sparse as sp
    import torch

    from diffusion_models_dev_project_tpu_torch.ops.cg import cg
    from diffusion_models_dev_project_tpu_torch.ops.woodbury import build_woodbury_sinv, woodbury_dc
    from diffusion_models_dev_project_tpu_torch.physics import cone_beam as CB
    from diffusion_models_dev_project_tpu_torch.physics import walnut as W
    from diffusion_models_dev_project_tpu_torch.physics.ray_trafo import nearest_resize
    from diffusion_models_dev_project_tpu_torch.scripts import _walnut_common as WC
    from diffusion_models_dev_project_tpu_torch.scripts import walnut_adapted as WA
    from diffusion_models_dev_project_tpu_torch.scripts import walnut_full_scale as WF

    config, config32, sde, score_fn = model_args
    out = {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="walnut_", dir=os.path.join(REPO, "build"))
    try:
        # ---- 12. operator: mask probe on the card, native assembly, .mat, densify, FDK
        t0 = time.perf_counter()
        vecs = WC.walnut_vecs()
        ts = time.perf_counter()
        trafo3 = W.get_single_slice_ray_trafo(vecs, 1, 2, WC.ASS, WC.CSS, WC.SLICE_CFG,
                                              device="cuda")
        torch.cuda.synchronize()
        out["mask_s"] = time.perf_counter() - ts
        geom = trafo3.geom
        ts = time.perf_counter()
        matrix = trafo3.assemble_matrix()
        out["assembly_s"] = time.perf_counter() - ts
        n_mask, nnz = matrix.shape[0], matrix.nnz
        log(f"  walnut geometry: {geom.num_angles} angles x {geom.num_cols} columns x "
            f"{geom.num_rows} rows, slab {geom.vol_shape}, {geom.n_steps()} samples a ray; mask "
            f"probe on the card {out['mask_s']:.2f} s ({n_mask} rays kept of "
            f"{int(np.prod(geom.proj_shape))}); native assembly {out['assembly_s']:.2f} s: "
            f"{matrix.shape[0]} x {matrix.shape[1]}, nnz {nnz} ({nnz / n_mask:.0f} a row)")
        if matrix.shape != (geom.num_angles * geom.num_cols, 501 * 501):
            raise AssertionError(f"walnut matrix of shape {matrix.shape}")
        # the native rows against the plain numpy assembly on random masked rays
        rng = np.random.default_rng(0)
        pick = np.sort(rng.choice(n_mask, NATIVE_CHECK_RAYS, replace=False))
        sub = np.zeros_like(trafo3.proj_mask)
        sub[tuple(np.argwhere(trafo3.proj_mask)[pick].T)] = True
        ts = time.perf_counter()
        plain = CB.masked_slice_matrix_plain(geom, sub).toarray()
        native = matrix[pick].toarray()
        bad = np.abs(native - plain) > TOL_NATIVE["atol"] + TOL_NATIVE["rtol"] * np.abs(plain)
        log(f"  native rows vs the plain assembly on {NATIVE_CHECK_RAYS} random masked rays: "
            f"max|diff| {np.abs(native - plain).max():.3e}, {int(bad.sum())} entries outside rtol "
            f"{TOL_NATIVE['rtol']}, atol {TOL_NATIVE['atol']} ({time.perf_counter() - ts:.1f} s)")
        if bad.any():
            raise AssertionError("the native walnut rows disagree with the plain assembly")
        del plain, native
        # the .mat round trip, bit-equal
        mat_file = os.path.join(work, W.matrix_filename(1, 2, WC.ASS, WC.CSS))
        ts = time.perf_counter()
        W.save_masked_ray_trafo_matrix(mat_file, trafo3, matrix, 1, 2, WC.ASS, WC.CSS)
        out["mat_save_s"] = time.perf_counter() - ts
        ts = time.perf_counter()
        loaded = W.load_masked_ray_trafo_matrix(mat_file)
        out["mat_load_s"] = time.perf_counter() - ts
        same = loaded.shape == matrix.shape and (sp.csr_matrix(loaded) != matrix).nnz == 0
        log(f"  .mat round trip: save {out['mat_save_s']:.2f} s, load {out['mat_load_s']:.2f} s, "
            f"{os.path.getsize(mat_file) / 1e6:.0f} MB, bit-equal {same}")
        if not same:
            raise AssertionError("the walnut .mat round trip changed the matrix")
        del loaded
        # the operators through the entry point (it loads the .mat saved above)
        kw = dict(walnut_id=1, orbit_id=2, angular_sub_sampling=WC.ASS,
                  proj_col_sub_sampling=WC.CSS, new_shape=(256, 256), vecs_all=vecs,
                  single_slice_config=WC.SLICE_CFG, device="cuda")
        rts = {}
        for impl in ("dense", "ell"):
            ts = time.perf_counter()
            rts[impl] = W.get_walnut_2d_ray_trafo(work, **kw, impl=impl)
            torch.cuda.synchronize()
            out[f"{impl}_build"] = dict(rts[impl].build_seconds, total=time.perf_counter() - ts)
            log(f"  get_walnut_2d_ray_trafo(impl={impl!r}): "
                + ", ".join(f"{k} {v:.2f} s" for k, v in out[f"{impl}_build"].items())
                + f"; fbp_scale {rts[impl].fbp_scale:.6g}")
        rt = rts["dense"]
        if tuple(rt.matrix.shape) != (n_mask, 256 * 256):
            raise AssertionError(f"dense walnut operator of shape {tuple(rt.matrix.shape)}")
        log(f"  dense operator {tuple(rt.matrix.shape)} fp32, "
            f"{rt.matrix.numel() * 4 / 1e9:.2f} GB on the card")
        # operator gates
        xr = torch.rand((1, 256, 256, 1), generator=gen, device="cuda")
        yr = torch.randn((1, 1, n_mask, 1), generator=gen, device="cuda")
        with torch.no_grad():
            ya, yb = rts["ell"].apply(xr), rt.apply(xr)
            ell_rel = float(torch.linalg.vector_norm(ya - yb) / torch.linalg.vector_norm(ya))
            lhs = float((rt.apply(xr).double() * yr.double()).sum())
            rhs = float((xr.double() * rt.adjoint(yr).double()).sum())
        adj_rel = abs(lhs - rhs) / abs(lhs)
        log(f"  ELL forward vs dense forward at the model grid: rel {ell_rel:.3e} (tol "
            f"{TOL_WALNUT_ELL}); dense <Ax, y> vs <x, Aᵀy>: rel {adj_rel:.3e} (tol {TOL_WALNUT_ADJ})")
        if not (ell_rel <= TOL_WALNUT_ELL and adj_rel <= TOL_WALNUT_ADJ):
            raise AssertionError("the walnut operators disagree")
        del rts["ell"]
        # the observation of the phantom on the model grid, and FDK
        gt501 = torch.from_numpy(WC.walnut_phantom(501))[None, :, :, None].cuda()
        gt_model = nearest_resize(gt501, (256, 256))
        g = torch.Generator(device="cuda").manual_seed(3)
        gt, obs, fdk = F.get_data_from_ground_truth(gt_model, rt, WALNUT_STDDEV, generator=g)
        out["fdk"] = psnr_ssim(fdk, gt, clamp=False)
        log(f"  walnut phantom on the model grid: FDK {out['fdk'][0]:.2f} dB / {out['fdk'][1]:.4f}")
        # the port's entry point in-process, without --ckpt, on this work
        # directory: the .mat and the dense cache load, and its FDK of the
        # dense observation (the same generator seed) is this phase's
        ts = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            ws = WF.main(["--workdir", work])
        for line in printed.getvalue().splitlines():
            log("  | " + line)
        ws_fdk = ws["dense_run"]["fdk_psnr"]
        out["entry"] = dict(seconds=time.perf_counter() - ts, fdk=ws_fdk, times=ws["times"],
                            rel_diff=ws["rel_diff"])
        del ws
        log(f"  walnut_full_scale in-process (no --ckpt): {out['entry']['seconds']:.1f} s; its dense "
            f"FDK {ws_fdk:.6f} dB, this phase's {out['fdk'][0]:.6f} dB (tol {TOL_WALNUT_FDK})")
        if not (abs(ws_fdk - out["fdk"][0]) <= TOL_WALNUT_FDK
                and "(.mat load)" in printed.getvalue()):
            raise AssertionError("walnut_full_scale did not load this phase's .mat, or its FDK "
                                 "differs from this phase's")
        # Woodbury: S⁻¹ once, then the residual of the exact solve
        sinv = build_woodbury_sinv(rt, WALNUT_GAMMA)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(3):
            sinv = build_woodbury_sinv(rt, WALNUT_GAMMA)
        ev[1].record()
        ev[1].synchronize()
        sinv_ms = ev[0].elapsed_time(ev[1]) / 3
        xhat0 = torch.randn((1, 256, 256, 1), generator=gen, device="cuda")
        with torch.no_grad():
            xw = woodbury_dc(rt, sinv, xhat0, obs)
            target = xhat0 + WALNUT_GAMMA * rt.adjoint(obs)
            resid = float(torch.linalg.vector_norm(xw + WALNUT_GAMMA * rt.adjoint(rt.apply(xw))
                                                   - target) / torch.linalg.vector_norm(target))
        log(f"  Woodbury x for one x̂₀: |(I + γAᵀA)x - (x̂₀ + γAᵀy)| / |x̂₀ + γAᵀy| = {resid:.3e} "
            f"at γ = {WALNUT_GAMMA} (tol {TOL_WOODBURY})")
        if not resid <= TOL_WOODBURY:
            raise AssertionError("the Woodbury solve misses the DDS proximal system")
        # device times (graph replay; S⁻¹'s build eagerly between CUDA events)
        rhs_dc = xhat0 + WALNUT_GAMMA * rt.adjoint(obs)
        dc_op = P.make_dc_op(rt, WALNUT_GAMMA)
        a_bytes = rt.matrix.numel() * 4
        n_img, n_obs = 256 * 256 * 4, n_mask * 4
        with torch.no_grad():
            times = {"apply": (time_ms(lambda: rt.apply(xhat0), 20), a_bytes + n_img + n_obs, 0),
                     "adjoint": (time_ms(lambda: rt.adjoint(obs), 20), a_bytes + n_img + n_obs, 0),
                     "CG(5)": (time_ms(lambda: cg(dc_op, xhat0, rhs_dc, n_iter=5), 5),
                               12 * (a_bytes + n_img + n_obs), 0),
                     "Woodbury DC": (time_ms(lambda: woodbury_dc(rt, sinv, xhat0, obs), 20),
                                     2 * (a_bytes + n_img + n_obs) + sinv.numel() * 4, 0),
                     # the least work: AAᵀ's upper triangle (n²k) and an SPD
                                   # inverse by Cholesky (n³), not inv's general 2n³
                     "S⁻¹ build": (sinv_ms, a_bytes + 2 * sinv.numel() * 4,
                                   1.0 * n_mask * n_mask * 65536 + 1.0 * n_mask ** 3)}
        out["times"] = {}
        for name, (ms, nbytes, flops) in times.items():
            b_ms, b_by, _, _ = bound(flops, nbytes, "float32")
            out["times"][name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
            log(f"  {name}: {ms:.3f} ms of device time "
                f"({'eager, CUDA events' if name == 'S⁻¹ build' else 'graph replay'}), bound "
                f"{b_ms:.3f} ms ({b_by}: {nbytes / 1e9:.3f} GB at {PEAK_BYTES / 1e12:.2f} TB/s, "
                f"{flops / 1e12:.2f} TFLOP at {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s fp32)")
        log(f"[phase 12 walnut operator] {time.perf_counter() - t0:.1f} s")

        # ---- 12. DDS with the shipped prior: CG, then the exact Woodbury solve
        t0 = time.perf_counter()
        out["dds"] = {}
        for mode in ("cg", "woodbury"):
            g = torch.Generator(device="cuda").manual_seed(7)
            x, counts, ms_step, med = timed_dds(F, P, score_fn, sde, rt, obs, steps, mode, g,
                                                f"walnut DDS ({mode})")
            q = psnr_ssim(x, gt)
            out["dds"][mode] = dict(psnr=q[0], ssim=q[1], ms_step=ms_step, med=med, counts=counts)
            log(f"  walnut DDS ({mode}, {steps} steps, γ {WALNUT_GAMMA}, η {WALNUT_ETA}): "
                f"{q[0]:.2f} dB / {q[1]:.4f} SSIM | FDK {out['fdk'][0]:.2f} dB | {ms_step:.2f} ms a "
                f"step; in the loop (CUDA events, median of the last {SPLIT_STEPS}): step "
                f"{med['step']:.2f} ms = UNet {med['unet']:.2f} + DC {med['cg']:.2f} + rest "
                f"{med['rest']:.2f}; launches " + json.dumps(counts))
        margins = {m: r["psnr"] - out["fdk"][0] for m, r in out["dds"].items()}
        agree = abs(out["dds"]["woodbury"]["psnr"] - out["dds"]["cg"]["psnr"])
        log(f"  walnut DDS - FDK: cg {margins['cg']:+.2f} dB, woodbury {margins['woodbury']:+.2f} dB "
            f"(gate: > {WALNUT_MARGIN_DB} dB); |woodbury - cg| {agree:.3f} dB (gate: <= "
            f"{WALNUT_AGREE_DB} dB)")
        if gate and min(margins.values()) <= WALNUT_MARGIN_DB:
            raise AssertionError(f"walnut DDS does not beat FDK by {WALNUT_MARGIN_DB} dB: {margins}")
        if gate and not agree <= WALNUT_AGREE_DB:
            raise AssertionError(f"walnut DDS with the Woodbury solve and with CG(5) differ by "
                                 f"{agree:.3f} dB (> {WALNUT_AGREE_DB})")
        log(f"[phase 12 walnut dds] {time.perf_counter() - t0:.1f} s")

        # ---- 12b. steerable (LoRA) adaptation through the dense operator: the
        # full-width gradient's gates, then the run through walnut_adapted
        t0 = time.perf_counter()
        m16, _, _ = F.get_standard_score(config, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
        m32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
        smp = {name: F.get_standard_adapted_sampler(
            "dds", m, sde, rt, obs, num_steps=WALNUT_ADAPT_STEPS, eta=WALNUT_ETA,
            gamma=WALNUT_GAMMA, tv_penalty=1e-6, lr=1e-3, num_optim_step=WALNUT_ADAPT_OPTIM,
            lora_rank=LORA_RANK, add_cg=True, dc_type="cg", cg_iter=1, ground_truth=gt,
            lora_seed=0) for name, m in (("bf16", m16), ("fp32", m32))}
        lora = {n: (v if n.endswith(".down") else 0.01 * torch.randn(v.shape, generator=gen,
                                                                     device="cuda"))
                for n, v in smp["bf16"].lora.items()}
        for s_ in smp.values():
            s_.lora = lora
        tg = torch.full((1,), 0.5, device="cuda")
        xg = gt + sde.marginal_prob_std(tg).reshape(1, 1, 1, 1) * torch.randn(
            gt.shape, generator=gen, device="cuda")
        reset_counts()
        loss_k, gk = adaptation_gradients(smp["bf16"], xg, tg, True)
        check_counts(read_counts(), 1, 1, "one forward and backward of the walnut adaptation loss")
        loss_p, gp = adaptation_gradients(smp["bf16"], xg, tg, False)
        loss_32, g32 = adaptation_gradients(smp["fp32"], xg, tg, False)
        loss_32k, g32k = adaptation_gradients(smp["fp32"], xg, tg, True)
        gradient_gates(gk, gp, g32, g32k, (loss_k, loss_p, loss_32, loss_32k),
                       f"walnut adaptation loss gradient through the dense operator, LoRA r={LORA_RANK}")
        del smp, m16, m32, gk, gp, g32, g32k, lora
        n = WALNUT_ADAPT_STEPS
        reset_counts()
        ts = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            wa = WA.main(["--ckpt", CKPT, "--sde", "vesde", "--num_steps", str(n),
                          "--num_optim_step", str(WALNUT_ADAPT_OPTIM), "--workdir", work])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - ts
        counts = read_counts()
        for line in printed.getvalue().splitlines():
            log("  | " + line)
        check_counts(counts, n * (WALNUT_ADAPT_OPTIM + 2) + 1, n * WALNUT_ADAPT_OPTIM,
                     "the adapted walnut run")
        if not (np.isfinite(wa["recon"]).all() and wa["recon"].shape == (256, 256)
                and abs(wa["fdk_psnr"] - out["fdk"][0]) <= TOL_WALNUT_FDK):
            raise AssertionError("walnut_adapted: a reconstruction not finite or of another "
                                 "shape, or its FDK is not this phase's")
        out["adapted"] = dict(psnr=wa["psnr"], ssim=wa["ssim"], wall_s=wall_s,
                              chain_s=wa["seconds"], counts=counts)
        del wa
        # the matched-budget control: plain DDS of as many steps, same observation
        plain = F.get_standard_sampler("dds", score_fn, sde, rt, obs, num_steps=n,
                                       im_shape=(256, 256, 1), gamma=WALNUT_GAMMA,
                                       eta=WALNUT_ETA, cg_iter=5)
        g = torch.Generator(device="cuda").manual_seed(7)
        out["plain_matched"] = psnr_ssim(plain.sample(generator=g)[0], gt)
        log(f"  adapted walnut through walnut_adapted ({n} x {WALNUT_ADAPT_OPTIM}, LoRA "
            f"r={LORA_RANK}, lr 1e-3, CG(5) in the loss, no CG in the step; a cut protocol, not "
            f"gated): {out['adapted']['psnr']:.2f} dB / {out['adapted']['ssim']:.4f} SSIM | plain "
            f"DDS {n} steps {out['plain_matched'][0]:.2f} dB / {out['plain_matched'][1]:.4f} | FDK "
            f"{out['fdk'][0]:.2f} dB | main {wall_s:.1f} s, the chain {out['adapted']['chain_s']:.1f} s, "
            f"{out['adapted']['chain_s'] / n * 1e3:.0f} ms per outer step; launches "
            + json.dumps(counts))
        log(f"[phase 12b walnut adapted] {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def aapm_phase(F, P, model_args, steps, gen, cli_workdir):
    """Phase 13: AAPM (synthetic slices of scripts/make_synth_aapm.py) through
    the conditional CLI, DDS through the parallel-beam matrix operator, and
    the AAPM config's full-width UNet, kernels against plain."""
    import tempfile

    import torch

    from diffusion_models_dev_project_tpu_torch import run_conditional_sampling as CLI
    from diffusion_models_dev_project_tpu_torch.configs import aapm_configs
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    config, _, sde, score_fn = model_args
    out = {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="aapm_", dir=os.path.join(REPO, "build"))
    old_env = os.environ.get("AAPM_DATA_PATH")
    try:
        t0 = time.perf_counter()
        slices = os.path.join(work, "slices")
        subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_aapm.py"),
                        "--out", slices, "--n", str(AAPM_SLICES)], check=True, timeout=300,
                       capture_output=True)
        os.environ["AAPM_DATA_PATH"] = slices
        # (a) the conditional CLI, ellipse prior on the AAPM test fold
        argv = ["--load_path", CKPT, "--num_channels", "128", "--model_learned_on", "ellipses",
                "--dataset", "aapm", "--method", "dds", "--num_steps", str(steps), "--eta", "0.85",
                "--num_images", "1"]
        os.makedirs(cli_workdir, exist_ok=True)
        cwd = os.getcwd()
        os.chdir(cli_workdir)
        try:
            reset_counts()
            ts = time.perf_counter()
            root = CLI.coordinator(CLI.parser.parse_args(argv))
            wall_s = time.perf_counter() - ts
            counts = read_counts()
            report = read_report(os.path.join(cli_workdir, root, "report.yaml"))
            with np.load(os.path.join(cli_workdir, root, "recon_0_info.npz")) as info:
                recon, g_np = info["recon"], info["ground_truth"]
        finally:
            os.chdir(cwd)
        check_counts(counts, steps, 0, "DDS on AAPM through the CLI")
        aconf = aapm_configs.get_config("vesde")
        trafo = F.get_standard_ray_trafo(aconf)
        g = torch.Generator(device="cuda").manual_seed(config.seed * 1000)
        gtt, _, fbp = F.get_data_from_ground_truth(g_np[..., None], trafo, aconf.data.stddev,
                                                   generator=g)
        fb = psnr_ssim(fbp, gtt, clamp=False)
        out["cli"] = dict(psnr=report["PSNR"], ssim=report["SSIM"], fbp=fb, wall_s=wall_s,
                          counts=counts)
        log(f"  DDS ({steps} steps, η 0.85) through the CLI, ellipse prior on AAPM test-fold "
            f"slice 0: {report['PSNR']:.2f} dB / {report['SSIM']:.4f} SSIM | FBP {fb[0]:.2f} dB / "
            f"{fb[1]:.4f} | {wall_s:.1f} s in the CLI, {wall_s / steps * 1e3:.2f} ms a step")
        if not (recon.shape == (256, 256) and np.isfinite(recon).all()
                and report["diverged_images"] == "[]" and report["PSNR"] > fb[0]):
            raise AssertionError("DDS on AAPM through the CLI does not beat FBP")
        log(f"[phase 13a aapm cli] {time.perf_counter() - t0:.1f} s")

        # (b) DDS through the parallel-beam matrix operator (Joseph, ELL), val image 0
        t0 = time.perf_counter()
        mconf = aapm_configs.get_config("vesde")
        mconf.data.part = "val"
        mconf.forward_op.impl = "matrix"
        ts = time.perf_counter()
        mtrafo = F.get_standard_ray_trafo(mconf)
        build_s = time.perf_counter() - ts
        image = F.get_standard_dataset(mconf)[0]
        g = torch.Generator(device="cuda").manual_seed(config.seed + 13)
        gtm, obs, fbp = F.get_data_from_ground_truth(image, mtrafo, mconf.data.stddev, generator=g)
        x, counts, ms_step, med = timed_dds(F, P, score_fn, sde, mtrafo, obs, steps, "cg", g,
                                            "DDS through the matrix operator")
        q, fb = psnr_ssim(x, gtm), psnr_ssim(fbp, gtm, clamp=False)
        with torch.no_grad():
            apply_ms = time_ms(lambda: mtrafo.apply(gtm), 20)
            adjoint_ms = time_ms(lambda: mtrafo.adjoint(obs), 20)
        out["matrix"] = dict(psnr=q[0], ssim=q[1], fbp=fb, ms_step=ms_step, med=med,
                             counts=counts, build_s=build_s, apply_ms=apply_ms,
                             adjoint_ms=adjoint_ms)
        log(f"  matrix operator (Joseph, ELL {tuple(mtrafo.fwd_idx.shape)} and "
            f"{tuple(mtrafo.adj_idx.shape)}, built in {build_s:.2f} s; apply {apply_ms:.3f} ms, "
            f"adjoint {adjoint_ms:.3f} ms of device time): DDS {steps} steps on AAPM val image 0 "
            f"{q[0]:.2f} dB / {q[1]:.4f} SSIM | FBP {fb[0]:.2f} dB / {fb[1]:.4f} | {ms_step:.2f} ms "
            f"a step = UNet {med['unet']:.2f} + CG(5) {med['cg']:.2f} + rest {med['rest']:.2f} "
            f"(medians)")
        if not q[0] > fb[0]:
            raise AssertionError("DDS through the matrix operator does not beat FBP")
        log(f"[phase 13b matrix operator] {time.perf_counter() - t0:.1f} s")

        # (c) the AAPM config's UNet at full width, random weights, kernels against plain
        t0 = time.perf_counter()
        cfg = aapm_configs.get_config("vesde")
        cfg.model.dtype = "bfloat16"
        model, _, _ = F.get_standard_score(cfg, F.get_standard_sde(cfg), load_model=False)
        with torch.no_grad():
            for p in model.parameters():       # the zero-initialised leaves drawn too
                if p.dim() > 1 and not p.any():
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
        n_params = sum(p.numel() for p in model.parameters())
        xa = torch.randn((1, 256, 256, 1), generator=gen, device="cuda") * 10.0
        ta = torch.full((1,), 0.5, device="cuda")
        calls = module_calls(model, xa, ta)
        want_conv = dict.fromkeys(C.VARIANTS, 0)
        for kind, _, shape, cout, dt in calls:
            if kind == "conv":
                want_conv[C.plan(*shape, cout, dt).variant] += 1
        n_attn = sum(kind == "attn" for kind, *_ in calls)
        reset_counts()
        with torch.no_grad():
            outk = model(xa, ta)
        counts = read_counts()
        with torch.no_grad():
            ref = model(xa, ta, use_kernel=False)
            fwd_dev = time_ms(lambda: model(xa, ta), 3)
        d, r = rel_err(outk, ref)
        log(f"  AAPM UNet (256 channels, learn_sigma, scale-shift norm, resblock up/down; "
            f"{n_params / 1e6:.1f}M parameters, random weights): out {tuple(outk.shape)}, "
            f"max|kernel - plain| {d:.3e}, rel {r:.3e} (tol {TOL_UNET}); {fwd_dev:.2f} ms of device "
            f"time; launches " + json.dumps(counts))
        if not (torch.isfinite(outk).all() and outk.shape == (1, 256, 256, 1) and r <= TOL_UNET):
            raise AssertionError("the AAPM UNet with kernels disagrees with the plain path")
        if (counts["conv_fwd_by"] != want_conv
                or counts["attn_fwd_by"] != by_variants(A.VARIANTS, mma=n_attn)
                or counts["conv_bwd"] or counts["attn_bwd"]):
            raise AssertionError(f"AAPM UNet launches {counts}, want conv3x3 {want_conv} and "
                                 f"{n_attn} mma attention")
        seen, handles = record_shapes(model)
        with torch.no_grad():
            model(xa, ta)
        for hnd in handles:
            hnd.remove()
        conv_tot, _, conv_variants = check_conv(seen["conv"], gen, extras=False)
        out["aapm_unet"] = dict(params=n_params, rel_err=r, fwd_dev_ms=fwd_dev, counts=counts,
                                conv={k: conv_tot[k] for k in ("ms", "plain_ms", "library_ms",
                                                               "bound_ms", "ops_ms", "bytes_ms")},
                                conv_variants={v: agg.get("calls", 0)
                                               for v, agg in conv_variants.items()})
        del model
        log(f"[phase 13c aapm unet] {time.perf_counter() - t0:.1f} s")
    finally:
        if old_env is None:
            os.environ.pop("AAPM_DATA_PATH", None)
        else:
            os.environ["AAPM_DATA_PATH"] = old_env
        shutil.rmtree(work, ignore_errors=True)
    return out


# phase 15: the 512² configuration and the evaluation entry points
DDS_512_STEPS = 20            # steps of the 512² DDS (scripts/smoke_512.py: 100; cut, PERF.md §4)
EVAL_STEPS = 50               # DDS steps of the eval entry points' runs (protocol: 1000)
EVAL_IMAGES = 2
EVAL_ADAPT = (5, 3)           # outer x inner steps of the adapted OOD case (protocol: 50 x 10)
EVAL_LINE = re.compile(r"^image (\d+): dds +(-?[\d.]+) dB / ([\d.]+) SSIM \| FBP +(-?[\d.]+) dB "
                       r"\| ([\d.]+)s$")
EVAL_MEAN = re.compile(r"^MEAN over (\d+): dds +(-?[\d.]+) dB / ([\d.]+) SSIM \| "
                       r"FBP +(-?[\d.]+) dB$")


def forward_counts(seen, n_fwd):
    """The launch counts of `n_fwd` forwards of a model whose conv3x3 and
    attention calls `record_shapes` saw, each call on the variant its
    plan picks; no backward."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    conv_by, attn_by = dict.fromkeys(C.VARIANTS, 0), dict.fromkeys(A.VARIANTS, 0)
    for (b, h, w, cin), cout, dt in seen["conv"]:
        conv_by[C.plan(b, h, w, cin, cout, getattr(torch, dt)).variant] += n_fwd
    for shape, dt in seen["attn"]:
        attn_by[A.plan(*shape, getattr(torch, dt)).variant] += n_fwd
    return {"conv_fwd": sum(conv_by.values()), "conv_fwd_by": conv_by,
            "conv_bwd": 0, "conv_bwd_by": dict.fromkeys(C.VARIANTS, 0),
            "conv_wgrad": 0, "conv_wgrad_by": dict.fromkeys(C.WGRAD_VARIANTS, 0),
            "attn_fwd": sum(attn_by.values()), "attn_fwd_by": attn_by,
            "attn_bwd": 0, "attn_bwd_by": dict.fromkeys(A.VARIANTS, 0)}


def phase_512_and_eval(F, P, gen, workdir):
    """Phase 15: 15a the kernels at every conv3x3 and attention shape of the
    512² UNet (128 channels) against their plain versions, timed, and
    attention at (4, 1024, 64), off the path; 15b its
    forward at full width with random weights (every leaf nonzero) against
    the plain path, launch counts exact; 15c the 512² DDS through
    `scripts/smoke_512.py` (`DDS_512_STEPS` steps), finite, counts exact,
    the step split into UNet, CG(10) and rest; 15d the evaluation entry
    points in-process: `scripts/eval_flagship_256.py` (VESDE, η 0.85,
    `EVAL_IMAGES` val images, `EVAL_STEPS` steps), each image above its FBP
    and its printed lines parsed, and `scripts/eval_adapted_256.py` on the
    OOD bars at `EVAL_ADAPT` with `EVAL_STEPS` DDS steps, finite; counts
    exact.  Returns the 512² kernel totals and launches."""
    import contextlib
    import io

    import torch

    from diffusion_models_dev_project_tpu_torch.ops.cg import cg
    from diffusion_models_dev_project_tpu_torch.scripts import eval_adapted_256 as EA
    from diffusion_models_dev_project_tpu_torch.scripts import eval_flagship_256 as EF
    from diffusion_models_dev_project_tpu_torch.scripts import smoke_512 as S512

    # ---- 15a. the kernels at the 512² UNet's shapes
    t0 = time.perf_counter()
    config = S512.config_512()
    sde = F.get_standard_sde(config)
    model, _, _ = F.get_standard_score(config, sde, load_model=False)
    with torch.no_grad():      # the init's zero leaves drawn nonzero: every layer counts
        for p in model.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    x = torch.randn((1, S512.IM, S512.IM, 1), generator=gen, device="cuda") * 10.0
    t = torch.full((1,), 0.5, device="cuda")
    seen, handles = record_shapes(model)
    with torch.no_grad():
        model(x, t)
    for hnd in handles:
        hnd.remove()
    attn_512 = sorted({(shape, dt) for shape, dt in seen["attn"]})
    tc_512 = [c for c in seen["conv"]
              if c[0][1] == S512.IM and c[1] % 64 == 0 and c[0][3] % 64 == 0]
    log(f"  512² UNet: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M parameters, "
        f"{len(seen['conv'])} conv3x3 and {len(seen['attn'])} attention calls per forward "
        f"(attention at {attn_512}: `attention_resolutions` 16 names the 16² maps)")
    if not tc_512:
        raise AssertionError("no 64-channel 512² conv of the 512² UNet runs tc")
    conv_tot, conv_err, conv_variants = check_conv(seen["conv"], gen, extras=False)
    attn_tot, attn_err = check_attention(seen["attn"], gen, extras=False)
    # T = 1024, the regime of the JAX package's flash kernel (its UNet picks
    # it at 1024 tokens or more), which no shipped config reaches: checked
    # and timed per call, not gated
    t1024, t1024_err = check_attention([((4, 1024, 64), "bfloat16")], gen, extras=False)
    log(f"[phase 15a kernels at 512²] {time.perf_counter() - t0:.1f} s")

    # ---- 15b. the 512² UNet forward at full width, kernels against plain
    t0 = time.perf_counter()
    with torch.no_grad():
        reset_counts()
        out = model(x, t)
        counts = read_counts()
        ref = model(x, t, use_kernel=False)
        fwd_ms = wall_ms(lambda: model(x, t), 5)
        fwd_dev_ms = time_ms(lambda: model(x, t), 5)
    d, r = rel_err(out, ref)
    want = forward_counts(seen, 1)
    log(f"  UNet 512² forward: out {tuple(out.shape)}, max|kernel - plain| {d:.3e}, rel {r:.3e} "
        f"(tol {TOL_UNET}); {fwd_ms:.2f} ms with kernels ({fwd_dev_ms:.2f} ms of device time, "
        f"replayed as a CUDA graph); launches " + json.dumps(counts))
    if not (torch.isfinite(out).all() and out.shape == x.shape and r <= TOL_UNET):
        raise AssertionError("the 512² UNet forward with kernels disagrees with the plain path")
    if counts != want:
        raise AssertionError(f"512² forward: launch counts {counts}, want {want}")
    del model, out, ref
    log(f"[phase 15b unet 512²] {time.perf_counter() - t0:.1f} s")

    # ---- 15c. the 512² DDS through the smoke entry point
    t0 = time.perf_counter()
    timer = StepTimer(None, P.cg, first_step=0)

    def timed(score_fn):
        timer.score_fn = score_fn
        return timer.score

    P.cg = timer.cg
    try:
        reset_counts()
        ts = time.perf_counter()
        res = S512.main(["--num_steps", str(DDS_512_STEPS), "--workdir", workdir],
                        score_wrap=timed)
        timer.finish()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - ts
        dds_counts = read_counts()
    finally:
        P.cg = cg
    rows = timer.split()
    med = {k: float(np.median([row[k] for row in rows])) for k in ("step", "unet", "cg", "rest")}
    log(f"  512² DDS ({DDS_512_STEPS} steps, random prior, γ 10, CG(10)): {res['psnr']:.2f} dB / "
        f"{res['ssim']:.4f} SSIM against FBP {res['fbp_psnr']:.2f} dB (printed, not gated: an "
        f"untrained prior); {wall_s:.1f} s in the entry point; per step (CUDA events, median of "
        f"{len(rows)}) {med['step']:.2f} ms = UNet {med['unet']:.2f} + CG(10) {med['cg']:.2f} + "
        f"rest {med['rest']:.2f}; launches " + json.dumps(dds_counts))
    if not (np.isfinite(res["recon"]).all() and res["recon"].shape == (S512.IM, S512.IM)):
        raise AssertionError("the 512² DDS reconstruction is not finite or of the wrong shape")
    if dds_counts != forward_counts(seen, DDS_512_STEPS):
        raise AssertionError(f"512² DDS: launch counts {dds_counts}, want "
                             f"{forward_counts(seen, DDS_512_STEPS)}")
    log(f"[phase 15c dds 512²] {time.perf_counter() - t0:.1f} s")

    # ---- 15d. the evaluation entry points in-process
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    try:
        printed = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(printed):
            ev = EF.main(["--ckpt", CKPT, "--eta", "0.85", "--num_images", str(EVAL_IMAGES),
                          "--num_steps", str(EVAL_STEPS)])
        eval_counts = read_counts()
        lines = printed.getvalue().splitlines()
        for line in lines:
            log("  eval_flagship_256: " + line)
        check_counts(eval_counts, EVAL_STEPS * EVAL_IMAGES, 0, "the flagship evaluation")
        parsed = [EVAL_LINE.match(line) for line in lines[:-1]]
        mean = EVAL_MEAN.match(lines[-1]) if lines else None
        if not (len(lines) == EVAL_IMAGES + 1 and all(parsed) and mean
                and [int(m.group(1)) for m in parsed] == list(range(EVAL_IMAGES))
                and int(mean.group(1)) == EVAL_IMAGES):
            raise AssertionError(f"the flagship evaluation's printed lines do not parse: {lines}")
        for i, (p, fp) in enumerate(zip(ev["psnr"], ev["fbp"])):
            if not p > fp:
                raise AssertionError(f"eval_flagship_256 image {i}: DDS {p:.2f} dB does not beat "
                                     f"FBP {fp:.2f} dB")
        n_out, n_in = EVAL_ADAPT
        reset_counts()
        rows = EA.main(["--ckpt", CKPT, "--num_in_dist", "0", "--num_ood", "1", "--num_steps",
                        str(n_out), "--num_optim_step", str(n_in), "--dds_steps", str(EVAL_STEPS)])
        ad_counts = read_counts()
    finally:
        os.chdir(cwd)
    check_counts(ad_counts, EVAL_STEPS + n_out * (n_in + 2) + 1, n_out * n_in,
                 "the adapted evaluation")
    if not (len(rows) == 1 and all(np.isfinite(rows[0][k]).all() for k in ("x_dds", "x_adapted"))):
        raise AssertionError("the adapted evaluation's reconstructions are not finite")
    log(f"  eval_adapted_256 ({rows[0]['name']}, {n_out} x {n_in}, DDS {EVAL_STEPS}; not gated): "
        f"adapted {rows[0]['adapted']:.2f} dB, DDS {rows[0]['dds']:.2f} dB, FBP "
        f"{rows[0]['fbp']:.2f} dB; launches " + json.dumps(ad_counts))
    log(f"[phase 15d eval entry points] {time.perf_counter() - t0:.1f} s")
    return dict(conv_tot=conv_tot, conv_err=conv_err, attn_tot=attn_tot, attn_err=attn_err,
                t1024=t1024, t1024_err=t1024_err, dds_counts=dds_counts,
                conv_variants={v: agg.get("calls", 0) for v, agg in conv_variants.items()})


def kernel_rows_512(ph15):
    """The `kernels` line's rows of the 512² configuration: times per 512²
    UNet forward, launches from its DDS run."""
    src = "diffusion_models_dev_project_tpu_torch/csrc/"
    rows = []
    for name, source, tot, err, key, replaces in (
            ("conv3x3 (512²)", src + "conv3x3_tc.cu", ph15["conv_tot"], ph15["conv_err"],
             "conv_fwd", "diffusion_models_dev_project_tpu/ops/conv3x3.py:35"),
            ("attention (512²)", src + "attention_mma.cu", ph15["attn_tot"], ph15["attn_err"],
             "attn_fwd", "diffusion_models_dev_project_tpu/ops/attention.py:43")):
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": ph15["dds_counts"][key], "max_abs_err": err, "ms": tot["ms"],
                     "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                     "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
                     "library_ms": tot["library_ms"]})
    rows[0]["variants"] = ph15["conv_variants"]
    rows[1]["library_best_ms"] = ph15["attn_tot"]["library_best_ms"]
    rows[1]["library_best"] = ph15["attn_tot"]["library_best"]
    # one call at (4, 1024, 64), off the path (no launches there)
    t = ph15["t1024"]
    rows[1]["t1024"] = {"shape": [4, 1024, 64], "max_abs_err": ph15["t1024_err"],
                        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                             "library_best_ms", "library_best", "simt_ms")},
                        "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"}
    return rows


def fp32_defaults_phase(F, ACLI, TRAIN_CLI, T, calls, workdir, bf16_train_ms):
    """Phase 10b: the adapted and the train CLI at their default compute
    dtype (the config's float32; no `--dtype`).  The adapted CLI's LoRA run
    (`FP32_ADAPT_STEPS` x `FP32_ADAPT_OPTIM`, add_cg) on val image 0, then
    the same in bf16; the train CLI warm-started from the shipped prior for
    `FP32_TRAIN_STEPS` steps at batch 3.  Launch counts exact, every fp32
    conv3x3 with Cin and Cout multiples of 64 on `tf32x3` (60 per forward,
    60 input and, training, 60 weight gradients per backward; the plain
    weight gradient never on CUDA); reconstructions and losses finite; ms
    per outer step and per training step printed beside the bf16 runs'
    (`bf16_train_ms`: phase 9's median step).  `calls`: `module_calls` of
    the flagship.  Returns the runs' counts and times."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    t0 = time.perf_counter()
    out = {}
    n, k = FP32_ADAPT_STEPS, FP32_ADAPT_OPTIM
    base = ["--load_path", CKPT, "--num_channels", "128", "--adaptation", "lora", "--num_steps",
            str(n), "--num_optim_step", str(k), "--add_cg", "--num_images", "1"]

    def on_val(get_configs):          # the CLI's data on the shipped val set
        def wrapped(args):
            config, dataconfig = get_configs(args)
            dataconfig.data.part = "val"
            return config, dataconfig
        return wrapped

    for dt, argv in (("float32", base), ("bfloat16", base + ["--dtype", "bfloat16"])):
        root, wall_s, counts, report = run_cli(ACLI, argv, os.path.join(workdir, dt),
                                               patch=(F, "get_standard_configs", on_val))
        check_counts(counts, n * (k + 2) + 1, n * k, f"the adapted CLI at {dt} (LoRA {n} x {k})",
                     dtype=dt)
        with np.load(os.path.join(root, "recon_0_info.npz")) as info:
            recon = info["recon"]
        if not (recon.shape == (256, 256) and np.isfinite(recon).all()):
            raise AssertionError(f"the adapted CLI at {dt}: reconstruction not finite")
        out["adapted", dt] = {"ms": wall_s / n * 1e3, "counts": counts}
        log(f"  adapted CLI, {'default dtype (float32)' if dt == 'float32' else '--dtype bfloat16'}, "
            f"LoRA {n} x {k} on val image 0: {report['PSNR']:.2f} dB / {report['SSIM']:.4f} SSIM (a "
            f"shortened protocol, not gated), {wall_s:.1f} s, {wall_s / n * 1e3:.0f} ms per outer step "
            f"(wall, the first step's weight splits included); launches " + json.dumps(counts))
    log(f"  adapted, ms per outer step: fp32 (tf32x3) {out['adapted', 'float32']['ms']:.0f}, bf16 (tc) "
        f"{out['adapted', 'bfloat16']['ms']:.0f}")

    # the train CLI: every leaf trains, so the 60 weight gradients run tf32x3 too
    calls32 = [(kind, name, shape, cout, None if dt is None else torch.float32)
               for kind, name, shape, cout, dt in calls]
    pattern = backward_pattern(calls32, lambda name: True)
    events, make_step, wgrad_reference, plain_wgrad = [], T.make_train_step, \
        C.conv3x3_weight_grad_reference, [0]

    def timed_make_train_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(*aa, **kk):
            e0 = StepTimer._event()
            loss = step(*aa, **kk)
            events.append((e0, StepTimer._event(), loss))
            return loss
        return timed

    def counted_reference(xx, gg):
        plain_wgrad[0] += xx.is_cuda
        return wgrad_reference(xx, gg)

    train_dir = os.path.join(workdir, "train")
    argv = ["--num_channels", "128", "--epochs", "1", "--steps_per_epoch", str(FP32_TRAIN_STEPS),
            "--init_ckpt", CKPT, "--lr_warmup", str(TRAIN_WARMUP), "--base_path", train_dir]
    T.make_train_step, C.conv3x3_weight_grad_reference = timed_make_train_step, counted_reference
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ts = time.perf_counter()
        TRAIN_CLI.coordinator(TRAIN_CLI.parser.parse_args(argv))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - ts
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        T.make_train_step, C.conv3x3_weight_grad_reference = make_step, wgrad_reference
    check_counts(counts, FP32_TRAIN_STEPS, FP32_TRAIN_STEPS, "the train CLI at float32",
                 per_backward=pattern, dtype="float32")
    step_ms = [a.elapsed_time(b) for a, b, _ in events]
    losses = [float(v) for _, _, v in events]
    if plain_wgrad[0] or len(step_ms) != FP32_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"the train CLI at float32: {len(step_ms)} steps, losses {losses}, "
                             f"{plain_wgrad[0]} plain weight gradients on CUDA")
    out["train"] = {"ms": float(np.median(step_ms)), "counts": counts}
    log(f"  train CLI, default dtype (float32), batch {TRAIN_BATCH}, {FP32_TRAIN_STEPS} steps warm-"
        f"started (--lr_warmup {TRAIN_WARMUP}): {wall_s:.1f} s in the CLI; per step (CUDA events) "
        + ", ".join(f"{v:.1f}" for v in step_ms) + f" ms, median {out['train']['ms']:.1f} ms against "
        f"{bf16_train_ms:.1f} in bf16 (phase 9); losses " + ", ".join(f"{v:.6e}" for v in losses)
        + f"; peak memory {peak_gb:.2f} GiB; launches " + json.dumps(counts))
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"[phase 10b fp32 defaults] {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=PHASE6_STEPS,
                    help="DDS steps per image of phase 6 (protocol: 1000)")
    ap.add_argument("--images", type=int, default=1, help="val images to reconstruct with DDS")
    ap.add_argument("--adapt-steps", type=int, default=50,
                    help="outer steps of the adapted phase (protocol: 50)")
    ap.add_argument("--adapt-images", type=int, default=2,
                    help="adapted images: val image 0, then the OOD bars phantom")
    ap.add_argument("--dps-steps", type=int, default=DPS_PROTOCOL_STEPS,
                    help="steps of the DPS and naive CLI runs (protocol: 1000)")
    ap.add_argument("--phase14", action="store_true",
                    help="run phase 14 (multi-card) alone, after the device and the build, against "
                         "one-card batch-4 runs of its own; prints no kernel line")
    ap.add_argument("--phase15", action="store_true",
                    help="run phase 15 (the 512² configuration, the evaluation entry points) "
                         "alone, after the device and the build; prints its kernel rows, not "
                         "the line")
    args = ap.parse_args()
    if args.images < 1 or args.adapt_images < 1 or args.adapt_steps < 2 or args.dps_steps < 6:
        raise SystemExit("chip_smoke: --images and --adapt-images must be at least 1, "
                         "--adapt-steps at least 2, --dps-steps at least 6")
    t_all = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs the card")
    sys.path.insert(0, REPO)
    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.ops import _build
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C
    from diffusion_models_dev_project_tpu_torch import run_conditional_sampling as CLI
    from diffusion_models_dev_project_tpu_torch.ops.cg import cg
    from diffusion_models_dev_project_tpu_torch.ops.diffusion import tweedy
    from diffusion_models_dev_project_tpu_torch.sampling import predictors as P
    from diffusion_models_dev_project_tpu_torch.utils.flops import fn_flops
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR, SSIM

    # ---- 1. device
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[phase 1 device] {time.perf_counter() - t0:.1f} s")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    nvcc_s = _build.build_seconds
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    sass = sass_counts(_build.build())
    log(f"  SASS of the library: {sass['HGMMA']} HGMMA, {sass['UTMALDG']} UTMALDG; HMMA: "
        + ", ".join(f"{n} in {name}" for name, n in sass["HMMA"].items()) + "; "
        + ", ".join(f"{c['HGMMA']} HGMMA and {c['UTMALDG']} UTMALDG in {name}"
                    for name, c in sass["by_function"].items()))
    if not (sass["HGMMA"] and sass["UTMALDG"] and all(sass["HMMA"].values())
            and all(c["HGMMA"] and c["UTMALDG"] for c in sass["by_function"].values())):
        raise AssertionError("the built library holds no HGMMA, no UTMALDG, no HMMA in one of "
                             f"{HMMA_FUNCTIONS} or no HGMMA or UTMALDG in one of {HGMMA_FUNCTIONS}")
    log(f"[phase 2 build] nvcc {nvcc_s:.1f} s, total {time.perf_counter() - t0:.1f} s")
    multicard_dir = os.path.join(REPO, "build", "chip_smoke_multicard")
    if args.phase14:
        from diffusion_models_dev_project_tpu_torch import run_adapted_sampling as ACLI

        config = get_config("vesde")
        one_card = one_card_batched(F, CLI, ACLI, config, F.get_standard_ray_trafo(config),
                                    os.path.join(REPO, "build", "chip_smoke_one_card"))
        multicard_phase(one_card, multicard_dir)
        log(smi.splitlines()[0])
        log(f"phase 14 alone: every gate held; whole run {time.perf_counter() - t_all:.1f} s")
        return
    if args.phase15:
        work = os.path.join(REPO, "build", "chip_smoke_512")
        ph15 = phase_512_and_eval(F, P, torch.Generator(device="cuda").manual_seed(0), work)
        shutil.rmtree(work, ignore_errors=True)
        log("phase 15 kernel rows: " + json.dumps(kernel_rows_512(ph15)))
        log(smi.splitlines()[0])
        log(f"phase 15 alone: every gate held; whole run {time.perf_counter() - t_all:.1f} s")
        return

    # ---- 3. kernels at the UNet's shapes
    t0 = time.perf_counter()
    config = get_config("vesde")
    config.model.num_channels = 128            # the shipped flagship prior
    config.model.dtype = "bfloat16"            # bf16 weights and compute, fp32 accumulation
    config.data.part = "val"
    sde = F.get_standard_sde(config)
    model, _, score_fn = F.get_standard_score(config, sde, ckpt_path=CKPT)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  UNet: {n_params / 1e6:.1f}M parameters from {os.path.relpath(CKPT, REPO)}, "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 256, 256, 1), generator=gen, device="cuda") * 10.0
    t = torch.full((1,), 0.5, device="cuda")
    seen, handles = record_shapes(model)
    with torch.no_grad():
        model(x, t)
    for hnd in handles:
        hnd.remove()
    conv_tot, conv_err, conv_variants = check_conv(seen["conv"], gen)
    attn_tot, attn_err = check_attention(seen["attn"], gen)
    conv_bwd_tot, conv_bwd_err, conv_bwd_variants, stem_bwd = check_conv_backward(seen["conv"], gen)
    wgrad_tots, wgrad_err, wgrad_variants = check_conv_wgrad(seen["conv"], gen)
    attn_bwd_tot, attn_bwd_err, attn_bwd_variants = check_attention_backward(seen["attn"], gen)
    attn_fp32 = attention_fp32_pass([shape for shape, _ in seen["attn"]], gen)
    attn_wide = check_attention_wide(gen)
    log(f"[phase 3 kernels] {time.perf_counter() - t0:.1f} s")

    # ---- 4. one full-width UNet forward, kernels against plain versions
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(x, t)
        ref = model(x, t, use_kernel=False)
        fwd_ms = wall_ms(lambda: model(x, t), 10)
        fwd_dev_ms = time_ms(lambda: model(x, t), 10)
        fwd_plain_ms = wall_ms(lambda: model(x, t, use_kernel=False), 5)
    torch.cuda.synchronize()
    d, r = rel_err(out, ref)
    log(f"  UNet 256² forward: out {tuple(out.shape)}, max|kernel - plain| {d:.3e}, rel {r:.3e} "
        f"(tol {TOL_UNET}); {fwd_ms:.2f} ms with kernels ({fwd_dev_ms:.2f} ms of device time, "
        f"replayed as a CUDA graph), {fwd_plain_ms:.2f} ms plain")
    if not (torch.isfinite(out).all() and out.shape == (1, 256, 256, 1) and r <= TOL_UNET):
        raise AssertionError("UNet forward with kernels disagrees with the plain path")
    # the FLOP counter (utils/flops.py): torch's counter plus the kernels' reports
    with torch.no_grad():
        total_flops, parts = fn_flops(model, x, t, breakdown=True)
    log(f"  FLOPs of one forward (utils/flops.py::fn_flops): {total_flops / 1e9:.2f} GFLOP = "
        + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in parts.items())
        + f"; the 62 conv3x3 launches against their shapes' sum {conv_tot['gflop']:.2f}")
    if not (math.isclose(parts.get("conv3x3", 0.0), conv_tot["gflop"] * 1e9, rel_tol=1e-9)
            and abs(parts["conv3x3"] / 1e9 - 369.9) < 0.05):
        raise AssertionError("the FLOP counter's conv3x3 work is not the 62 convs' 369.9 GFLOP")
    log(f"[phase 4 unet] {time.perf_counter() - t0:.1f} s")

    # ---- 5. full-width gradient of the adaptation loss, kernels against plain
    t0 = time.perf_counter()
    model_l, _, _ = F.get_standard_score(config, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
    config32 = copy.deepcopy(config)
    config32.model.dtype = "float32"
    model_32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
    trafo = F.get_standard_ray_trafo(config)
    images = np.load(VALSET)["images"]                          # (N, 256, 256, 1)
    g = torch.Generator(device="cuda").manual_seed(config.seed)
    gt, obs, _ = F.get_data_from_ground_truth(images[0], trafo, config.data.stddev, generator=g)
    samplers = {name: F.get_standard_adapted_sampler(
        "dds", m, sde, trafo, obs, num_steps=50, lora_rank=LORA_RANK, add_cg=True, cg_iter=1,
        dc_type="cg", tv_penalty=1e-6, lr=1e-3) for name, m in (("bf16", model_l), ("fp32", model_32))}
    # every up-projection drawn nonzero, so that every branch carries gradient
    lora = {n: (v if n.endswith(".down") else 0.01 * torch.randn(v.shape, generator=gen, device="cuda"))
            for n, v in samplers["bf16"].lora.items()}
    for smp in samplers.values():
        smp.lora = lora
    tg = torch.full((1,), 0.5, device="cuda")
    xg = gt + sde.marginal_prob_std(tg).reshape(1, 1, 1, 1) * torch.randn(
        gt.shape, generator=gen, device="cuda")
    reset_counts()
    loss_k, gk = adaptation_gradients(samplers["bf16"], xg, tg, True)
    counts = read_counts()
    check_counts(counts, 1, 1, "one forward and backward of the adaptation loss")
    loss_p, gp = adaptation_gradients(samplers["bf16"], xg, tg, False)
    loss_32, g32 = adaptation_gradients(samplers["fp32"], xg, tg, False)
    loss_32k, g32k = adaptation_gradients(samplers["fp32"], xg, tg, True)
    del samplers["fp32"], model_32
    gradient_gates(gk, gp, g32, g32k, (loss_k, loss_p, loss_32, loss_32k),
                   f"adaptation loss gradient at 256², LoRA r={LORA_RANK}")
    log("  launches of one forward and backward: " + json.dumps(counts))
    sampler = samplers["bf16"]
    with sampler.adapting():
        params = list(sampler.trainable.values())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = sampler.adaptation_loss(xg, tg)
        ev[1].record()
        torch.autograd.grad(loss, params)
        ev[2].record()
        torch.cuda.synchronize()
        del loss                    # its graph would hold the gradient accumulators
        fwd_wall, bwd_wall = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        fwd_dev = time_ms(lambda: sampler.adaptation_loss(xg, tg).detach(), 3)
        both_dev = time_ms(lambda: torch.autograd.grad(sampler.adaptation_loss(xg, tg), params), 3)
    log(f"  one forward + backward of the loss: wall {fwd_wall:.2f} + {bwd_wall:.2f} ms (CUDA events, "
        f"eager); device time (graph replay) forward {fwd_dev:.2f} ms, forward + backward "
        f"{both_dev:.2f} ms, so the backward {both_dev - fwd_dev:.2f} ms")
    log(f"[phase 5 gradient] {time.perf_counter() - t0:.1f} s")

    # ---- 5b. the UNet with heads past 128 through the wide kernels
    t0 = time.perf_counter()
    wide_unet = wide_head_unet_phase(F, config, sde, trafo, obs, xg, tg)
    log(f"[phase 5b wide heads] {time.perf_counter() - t0:.1f} s")

    # ---- 6. DDS reconstruction through the factory entry points
    t0 = time.perf_counter()
    reset_counts()
    step_s, results, splits = [], [], []
    for i, img in enumerate(images[:args.images]):
        g = torch.Generator(device="cuda").manual_seed(config.seed + i)
        gt, obs, fbp = F.get_data_from_ground_truth(img, trafo, config.data.stddev, generator=g)
        timer = StepTimer(score_fn, P.cg, first_step=max(args.steps - SPLIT_STEPS, 0))
        sampler = F.get_standard_sampler("dds", timer.score, sde, trafo, obs, num_steps=args.steps,
                                         im_shape=(256, 256, 1), gamma=0.01, eta=0.85, cg_iter=5)
        torch.cuda.synchronize()
        P.cg = timer.cg                # the sampler's CG solve, between CUDA events
        try:
            ts = time.perf_counter()
            xr, _ = sampler.sample(generator=g)
            timer.finish()
            torch.cuda.synchronize()
            step_s.append((time.perf_counter() - ts) / args.steps)
        finally:
            P.cg = cg
        splits.extend(timer.split())
        rec = xr[0, ..., 0].float().cpu().numpy()
        g_np, f_np = gt[0, ..., 0].cpu().numpy(), fbp[0, ..., 0].cpu().numpy()
        if not (xr.shape == (1, 256, 256, 1) and np.isfinite(rec).all()):
            raise AssertionError(f"image {i}: reconstruction not finite or of the wrong shape")
        rec = np.clip(rec, 0, 1)
        p, s, fp, fs = PSNR(rec, g_np), SSIM(rec, g_np), PSNR(f_np, g_np), SSIM(f_np, g_np)
        results.append((p, fp))
        log(f"  image {i}: DDS {p:.2f} dB / {s:.4f} SSIM | FBP {fp:.2f} dB / {fs:.4f} SSIM | "
            f"{step_s[-1] * 1e3:.2f} ms/step")
    n_fwd = args.steps * len(results)
    conv_launches, attn_launches = C.launches, A.launches
    by_variant, attn_by_variant = dict(C.launches_by_variant), dict(A.launches_by_variant)
    log(f"  launches in the DDS run: conv3x3 {conv_launches} ({conv_launches / n_fwd:g} per forward: "
        + ", ".join(f"{v} {k / n_fwd:g}" for v, k in by_variant.items())
        + f"), attention {attn_launches} ({attn_launches / n_fwd:g} per forward: "
        + ", ".join(f"{v} {k / n_fwd:g}" for v, k in attn_by_variant.items()) + ")")
    ms_step = 1e3 * float(np.mean(step_s))
    log(f"  DDS {args.steps} steps x {len(results)} images: {ms_step:.2f} ms/step, "
        f"{1e3 / ms_step:.2f} steps/s, mean PSNR {np.mean([p for p, _ in results]):.2f} dB "
        f"vs FBP {np.mean([f for _, f in results]):.2f} dB")
    # inside the loop: medians over the last steps of each image
    med = {key: float(np.median([row[key] for row in splits])) for key in ("step", "unet", "cg", "rest")}
    log(f"  per step inside the DDS loop (CUDA events, median of the last {len(splits)} steps over "
        f"{len(results)} images): step {med['step']:.2f} ms = UNet forward {med['unet']:.2f} ms + "
        f"CG(5) {med['cg']:.2f} ms + rest {med['rest']:.2f} ms (the rest: Tweedie, DDIM, noise, "
        f"and the loop's own host time)")
    if min(min(row.values()) for row in splits) < 0:
        raise AssertionError("a part of a DDS step timed negative")
    # device time of the CG solve and the fused Gram, each alone (graph replay)
    xhat0 = torch.randn((1, 256, 256, 1), generator=gen, device="cuda")
    dc_op = P.make_dc_op(sampler.ray_trafo, 0.01)
    cg_dev_ms = time_ms(lambda: cg(dc_op, xhat0, xhat0 + 0.01 * sampler.rhs, n_iter=5), 10)
    gram_ms = time_ms(lambda: sampler.ray_trafo.gram(xhat0), 20)
    log(f"  device time alone (graph replay): UNet forward {fwd_dev_ms:.2f} ms (phase 4), CG(5) "
        f"{cg_dev_ms:.2f} ms (fused Gram {gram_ms:.3f} ms each); together at most "
        f"{(fwd_dev_ms + cg_dev_ms) / ms_step:.0%} of the step")
    if conv_launches != 62 * n_fwd or attn_launches != 4 * n_fwd:
        raise AssertionError("the DDS run did not launch 62 conv3x3 and 4 attention kernels per forward")
    if by_variant != by_variants(C.VARIANTS, tc=60 * n_fwd, narrow=n_fwd, simt=n_fwd):
        raise AssertionError(f"conv3x3 launches by variant {by_variant}: want 60 tc, 1 narrow "
                             "and 1 simt per forward")
    if attn_by_variant != by_variants(A.VARIANTS, mma=4 * n_fwd):
        raise AssertionError(f"attention launches by variant {attn_by_variant}: want 4 mma and "
                             "no other per forward")
    for i, (p, fp) in enumerate(results):
        if not p > fp:
            raise AssertionError(f"image {i}: DDS {p:.2f} dB does not beat FBP {fp:.2f} dB")
    if C.backward_launches or A.backward_launches:
        raise AssertionError("the DDS run launched a backward kernel")
    log(f"[phase 6 dds] {time.perf_counter() - t0:.1f} s")

    # ---- 7. LoRA-adapted DDS of val image 0 and the OOD bars phantom
    t0 = time.perf_counter()
    phantoms = adapted_phantoms(images)
    adapt_counts, adapt_rows = None, []
    n_steps = args.adapt_steps
    for i, (what, img) in enumerate(phantoms[:args.adapt_images]):
        g = torch.Generator(device="cuda").manual_seed(config.seed + 100 + i)
        gt, obs, fbp = F.get_data_from_ground_truth(img, trafo, config.data.stddev, generator=g)
        n_optim = PHASE7_VAL_OPTIM if i == 0 else ADAPT_PROTOCOL_OPTIM
        sampler = adapted_sampler(F, model_l, sde, trafo, obs, gt, n_steps, lora_seed=i,
                                  n_optim=n_optim)
        timer = AdaptTimer(sampler)
        torch.cuda.synchronize()
        reset_counts()
        ts = time.perf_counter()
        xa, trace = sampler.sample(generator=g, return_trace=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - ts
        counts = read_counts()
        check_counts(counts, n_steps * (n_optim + 2) + 1, n_steps * n_optim, f"adapted {what}")
        adapt_counts = counts if adapt_counts is None else {
            k: (v + counts[k] if isinstance(v, int) else {kk: vv + counts[k][kk] for kk, vv in v.items()})
            for k, v in adapt_counts.items()}
        if n_optim == ADAPT_PROTOCOL_OPTIM:
            adapt_rows.extend(timer.split())
        dds = F.get_standard_sampler("dds", score_fn, sde, trafo, obs, num_steps=n_steps,
                                     im_shape=(256, 256, 1), gamma=0.01, eta=0.85, cg_iter=5)
        xd, _ = dds.sample(generator=g)
        g_np, f_np = gt[0, ..., 0].cpu().numpy(), fbp[0, ..., 0].cpu().numpy()
        rec = {}
        for name, xr in (("adapted", xa), ("dds", xd)):
            r = xr[0, ..., 0].float().cpu().numpy()
            if not (xr.shape == (1, 256, 256, 1) and np.isfinite(r).all()):
                raise AssertionError(f"{what}: {name} reconstruction not finite or of the wrong shape")
            r = np.clip(r, 0, 1)
            rec[name] = (PSNR(r, g_np), SSIM(r, g_np))
        fb = (PSNR(f_np, g_np), SSIM(f_np, g_np))
        tr = trace.float().cpu().numpy()
        log(f"  {what}: adapted ({n_steps} x {n_optim}) {rec['adapted'][0]:.2f} dB / "
            f"{rec['adapted'][1]:.4f} SSIM | "
            f"DDS {n_steps} steps {rec['dds'][0]:.2f} dB / {rec['dds'][1]:.4f} | FBP {fb[0]:.2f} dB / "
            f"{fb[1]:.4f} | {wall_s:.1f} s, {wall_s / n_steps * 1e3:.0f} ms per outer step; Tweedie "
            f"PSNR trace {tr[0]:.2f} -> {tr[len(tr) // 2]:.2f} -> {tr[-1]:.2f} dB")
        # the quality gate holds the protocol's 50 outer steps (or more); a
        # shortened probe (--adapt-steps) prints its numbers ungated
        if n_steps >= ADAPT_PROTOCOL_STEPS and not rec["adapted"][0] > fb[0]:
            raise AssertionError(f"{what}: adapted {rec['adapted'][0]:.2f} dB does not beat FBP "
                                 f"{fb[0]:.2f} dB")
    if adapt_rows:
        med = {k: float(np.median([row[k] for row in adapt_rows]))
               for k in ("step", "adapt", "fwd_adapted", "fwd_prior", "rest")}
        log(f"  per outer step (CUDA events, median of {len(adapt_rows)} steps): step "
            f"{med['step']:.1f} ms = adaptation {med['adapt']:.1f} ms ({ADAPT_PROTOCOL_OPTIM} Adam steps, "
            f"{med['adapt'] / ADAPT_PROTOCOL_OPTIM:.1f} ms each) + adapted forward {med['fwd_adapted']:.2f} ms + prior "
            f"forward {med['fwd_prior']:.2f} ms + rest {med['rest']:.2f} ms (Tweedie, cg(1), DDIM)")
    log("  launches in the adapted runs: " + json.dumps(adapt_counts))
    log(f"[phase 7 adapted] {time.perf_counter() - t0:.1f} s")

    # ---- 8. DPS: the full-width gradient in x, then DPS and naive through the CLI
    t0 = time.perf_counter()
    del model_l, samplers, sampler
    model_f32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT)
    g = torch.Generator(device="cuda").manual_seed(config.seed)
    gt, obs, _ = F.get_data_from_ground_truth(images[0], trafo, config.data.stddev, generator=g)
    nll = P.make_nloglik(trafo, obs)
    td = torch.full((1,), DPS_T, device="cuda")
    xd = gt + sde.marginal_prob_std(td).reshape(1, 1, 1, 1) * torch.randn(
        gt.shape, generator=gen, device="cuda")

    def dps_loss(m, xx, use_kernel=True):
        return nll(tweedy(m(xx, td, use_kernel=use_kernel), xx, sde, td))

    def dps_gradient(m, use_kernel):
        xx = xd.detach().requires_grad_(True)
        loss = dps_loss(m, xx, use_kernel)
        return float(loss.detach()), torch.autograd.grad(loss, xx)[0]

    def rel2(a, b):
        return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))

    reset_counts()
    loss_k, gk = dps_gradient(model, True)
    dps_grad_counts = read_counts()
    check_counts(dps_grad_counts, 1, 1, "one forward and backward of the DPS loss", stem_grad=True)
    loss_p, gp = dps_gradient(model, False)
    loss_32, g32 = dps_gradient(model_f32, False)
    loss_32k, g32k = dps_gradient(model_f32, True)
    del model_f32
    e_kp, e_f32 = rel2(gk, gp), rel2(g32k, g32)
    log(f"  DPS gradient in x at 256², t = {DPS_T}: loss bf16 kernels {loss_k:.6e}, bf16 plain "
        f"{loss_p:.6e}, fp32 plain {loss_32:.6e}, fp32 kernels {loss_32k:.6e}; |g_a - g_b| / |g_b|: "
        f"bf16 kernels vs bf16 plain {e_kp:.3e} (tol {TOL_GRAD_ALL}), fp32 kernels vs fp32 plain "
        f"{e_f32:.3e} (tol {TOL_GRAD_FP32}); vs the fp32 plain gradient: bf16 kernels "
        f"{rel2(gk, g32):.3e}, bf16 plain {rel2(gp, g32):.3e}")
    log("  launches of one forward and backward: " + json.dumps(dps_grad_counts))
    if not (all(torch.isfinite(v).all() for v in (gk, gp, g32, g32k))
            and e_kp <= TOL_GRAD_ALL and e_f32 <= TOL_GRAD_FP32):
        raise AssertionError("the full-width DPS gradient with kernels disagrees with the plain path")
    xleaf = xd.detach().clone().requires_grad_(True)
    with torch.no_grad():
        dps_fwd_wall = wall_ms(lambda: dps_loss(model, xleaf), 5)
        dps_fwd_dev = time_ms(lambda: dps_loss(model, xleaf), 3)
    dps_both_wall = wall_ms(lambda: torch.autograd.grad(dps_loss(model, xleaf), xleaf), 5)
    dps_both_dev = time_ms(lambda: torch.autograd.grad(dps_loss(model, xleaf), xleaf), 3)
    log(f"  one DPS loss (score, Tweedie, ||y - Ax||): forward wall {dps_fwd_wall:.2f} ms, device "
        f"{dps_fwd_dev:.2f} ms; forward + backward wall {dps_both_wall:.2f} ms, device "
        f"{dps_both_dev:.2f} ms (wall: CUDA events around eager calls; device: graph replay)")

    # DPS and naive through the CLI, on its default data, each run from the
    # prior and from the FBP (the last steps of the same grid); outputs under build/
    workdir = os.path.join(REPO, "build", "chip_smoke_cli")
    os.makedirs(workdir, exist_ok=True)
    n_dps = args.dps_steps
    # the grid of each run, and the grid from which on the CLI's divergence
    # guard is gated (a shortened --dps-steps probe's coarser steps may leave it)
    grid = {("dps", "prior"): min(n_dps, DPS_PRIOR_STEPS),
            ("naive", "prior"): min(n_dps, DPS_PRIOR_STEPS),
            ("dps", "fbp"): n_dps, ("naive", "fbp"): n_dps}
    guard_grid = {run: DPS_PRIOR_STEPS if run[1] == "prior" else DPS_PROTOCOL_STEPS
                  for run in grid}
    steps_run = {run: n if run[1] == "prior" else n - math.ceil(DPS_FBP_PCT * n)
                 for run, n in grid.items()}
    cli_runs = {}
    for start in ("prior", "fbp"):
        for method in ("dps", "naive"):
            argv = ["--load_path", CKPT, "--num_channels", "128", "--method", method, "--penalty",
                    str(DPS_PENALTY), "--num_steps", str(grid[method, start]), "--num_images", "1"]
            if start == "fbp":
                argv += ["--pct_chain_elapsed", str(DPS_FBP_PCT)]
            timer = PredictorTimer(P)
            cwd = os.getcwd()
            os.chdir(workdir)
            try:
                torch.cuda.synchronize()
                reset_counts()
                ts = time.perf_counter()
                root = CLI.coordinator(CLI.parser.parse_args(argv))
                wall_s = time.perf_counter() - ts
                counts = read_counts()
            finally:
                os.chdir(cwd)
                timer.remove()
            what = f"{method} from the {start} through the CLI"
            n = steps_run[method, start]
            check_counts(counts, n, n if method == "dps" else 0, what, stem_grad=True)
            ms_step, med_step, med_grad = timer.split(SPLIT_STEPS)
            report = read_report(os.path.join(workdir, root, "report.yaml"))
            with np.load(os.path.join(workdir, root, "recon_0_info.npz")) as info:
                recon, g_np = info["recon"], info["ground_truth"]
            cli_runs[method, start] = dict(report=report, counts=counts, ms_step=ms_step,
                                           med_step=med_step, med_grad=med_grad, wall_s=wall_s,
                                           gt=g_np)
            if not (recon.shape == (256, 256) and np.isfinite(recon).all()
                    and (grid[method, start] < guard_grid[method, start]
                         or report["diverged_images"] == "[]")):
                raise AssertionError(f"{what}: reconstruction of the wrong shape, not finite or "
                                     f"diverged ({report['diverged_images']})")
    # FBP of the same observation: the CLI's per-image seed (config seed x 1000 + image)
    g_np = cli_runs["dps", "prior"]["gt"]
    if not all(np.array_equal(g_np, run["gt"]) for run in cli_runs.values()):
        raise AssertionError("the CLI runs reconstructed different images")
    g = torch.Generator(device="cuda").manual_seed(config.seed * 1000)
    _, _, fbp = F.get_data_from_ground_truth(g_np[..., None], trafo, config.data.stddev, generator=g)
    f_np = fbp[0, ..., 0].cpu().numpy()
    fb = (PSNR(f_np, g_np), SSIM(f_np, g_np))
    for (method, start), run in cli_runs.items():
        rep = run["report"]
        log(f"  {method} from the {start} (penalty {DPS_PENALTY:g}, {steps_run[method, start]} steps "
            f"of {grid[method, start]}) through the CLI, "
            f"test-fold image 0: {rep['PSNR']:.2f} dB / {rep['SSIM']:.4f} SSIM | FBP {fb[0]:.2f} dB / "
            f"{fb[1]:.4f} | diverged images {rep['diverged_images']} | {run['wall_s']:.1f} s in the "
            f"CLI, {run['ms_step']:.2f} ms per step")
    for start in ("prior", "fbp"):
        dps, naive = cli_runs["dps", start], cli_runs["naive", start]
        log(f"  per step from the {start} (CUDA events, median of the last "
            f"{min(SPLIT_STEPS, steps_run['dps', start] - 1)} steps): DPS {dps['med_step']:.2f} ms = score forward + "
            f"backward through Tweedie and the data fit {dps['med_grad']:.2f} ms + rest "
            f"{dps['med_step'] - dps['med_grad']:.2f} ms; naive {naive['med_step']:.2f} ms, of it the "
            f"data fit's gradient {naive['med_grad']:.2f} ms")
    dps, naive = cli_runs["dps", "prior"], cli_runs["naive", "prior"]
    log(f"  device time alone (graph replay): DPS forward + backward {dps_both_dev:.2f} ms, so at most "
        f"{dps_both_dev / dps['med_step']:.0%} of a DPS step; UNet forward {fwd_dev_ms:.2f} ms "
        f"(phase 4), at most {fwd_dev_ms / naive['med_step']:.0%} of a naive step with the data "
        f"fit's gradient")
    for (method, start), run in cli_runs.items():
        log(f"  launches in the {method} run from the {start}: " + json.dumps(run["counts"]))
    # from the prior the shipped prior's biased score at large sigma sets the
    # result (PERF.md §6): printed, not gated; from the FBP DPS must win
    margins = {start: cli_runs["dps", start]["report"]["PSNR"] - cli_runs["naive", start]["report"]["PSNR"]
               for start in ("prior", "fbp")}
    log(f"  DPS - naive: from the prior {margins['prior']:+.2f} dB (not gated), from the FBP "
        f"{margins['fbp']:+.2f} dB (gate on a grid of {DPS_PROTOCOL_STEPS} steps or more: > "
        f"{DPS_MARGIN_DB} dB)")
    if n_dps >= DPS_PROTOCOL_STEPS and not margins["fbp"] > DPS_MARGIN_DB:
        raise AssertionError(f"from the FBP, DPS {cli_runs['dps', 'fbp']['report']['PSNR']:.2f} dB does "
                             f"not beat naive {cli_runs['naive', 'fbp']['report']['PSNR']:.2f} dB by "
                             f"{DPS_MARGIN_DB} dB")
    log(f"[phase 8 dps] {time.perf_counter() - t0:.1f} s")

    # ---- 9. training through the train CLI: the flagship warm-started, then DDPM from the fresh init
    t0 = time.perf_counter()
    from diffusion_models_dev_project_tpu_torch import run_score_based_models_train as TRAIN_CLI
    from diffusion_models_dev_project_tpu_torch.training import losses as L
    from diffusion_models_dev_project_tpu_torch.training import trainer as T
    from diffusion_models_dev_project_tpu_torch.training.ema import ema_init

    # 9a. the first step's loss and full gradient, kernels against plain
    model_t, _, _ = F.get_standard_score(config, sde, ckpt_path=CKPT, train=True)
    _, batches = F.get_standard_train_dataset(config)
    batch = next(batches)
    tt, zz = L.draw_time_and_noise(batch, sde, T.step_generator(config.seed, 0, "cuda"))

    def train_loss(m, use_kernel=True):
        return L.score_matching_loss(batch, lambda xx, t_: m(xx, t_, use_kernel=use_kernel), sde,
                                     t=tt, z=zz)

    def train_grads(m, use_kernel):
        names = [n for n, _ in m.named_parameters()]
        loss = train_loss(m, use_kernel)
        return float(loss.detach()), dict(zip(names, torch.autograd.grad(loss, list(m.parameters()))))

    calls = module_calls(model_t, batch, tt)
    train_pattern = backward_pattern(calls, lambda name: True)
    reset_counts()
    loss_k, gk = train_grads(model_t, True)
    train_counts = read_counts()
    check_counts(train_counts, 1, 1, "one training forward and backward", per_backward=train_pattern)
    loss_p, gp = train_grads(model_t, False)
    model_t32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT, train=True)
    loss_32, g32 = train_grads(model_t32, False)
    loss_32k, g32k = train_grads(model_t32, True)
    del model_t32
    gradient_gates(gk, gp, g32, g32k, (loss_k, loss_p, loss_32, loss_32k),
                   f"score-matching loss gradient at 256², batch {TRAIN_BATCH}, every parameter")
    del gk, gp, g32, g32k
    log("  launches of one training forward and backward: " + json.dumps(train_counts))
    params = list(model_t.parameters())
    with torch.no_grad():
        train_fwd_dev = time_ms(lambda: train_loss(model_t), 2)
    train_both_dev = time_ms(lambda: torch.autograd.grad(train_loss(model_t), params), 2)
    # the warm-start prior's loss on each batch, t and z that the CLI's steps draw
    prior_losses = []
    _, batches = F.get_standard_train_dataset(config)
    with torch.no_grad():
        for k in range(TRAIN_STEPS):
            bk = next(batches)
            tk, zk = L.draw_time_and_noise(bk, sde, T.step_generator(config.seed, k, "cuda"))
            prior_losses.append(float(L.score_matching_loss(bk, model_t, sde, t=tk, z=zk)))
    del model_t, params

    # 9b. the train CLI: warm start from the shipped prior, TRAIN_STEPS steps, the DDS probe
    workdir = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(workdir, ignore_errors=True)
    argv = ["--num_channels", "128", "--dtype", "bfloat16", "--epochs", "1", "--steps_per_epoch",
            str(TRAIN_STEPS), "--init_ckpt", CKPT, "--lr_warmup", str(TRAIN_WARMUP),
            "--keep_best_probe", "dds", "--base_path", workdir]
    step_events, step_losses, make_step = [], [], T.make_train_step
    plain_wgrad, wgrad_reference = [0], C.conv3x3_weight_grad_reference

    def timed_make_train_step(*a, **k):
        step = make_step(*a, **k)

        def timed(*aa, **kk):
            e0 = StepTimer._event()
            out = step(*aa, **kk)
            step_events.append((e0, StepTimer._event()))
            step_losses.append(out)
            return out
        return timed

    def counted_reference(xx, gg):
        plain_wgrad[0] += xx.is_cuda
        return wgrad_reference(xx, gg)

    T.make_train_step, C.conv3x3_weight_grad_reference = timed_make_train_step, counted_reference
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ts = time.perf_counter()
        state = TRAIN_CLI.coordinator(TRAIN_CLI.parser.parse_args(argv))
        torch.cuda.synchronize()
        train_wall_s = time.perf_counter() - ts
        train_run_counts = read_counts()
        train_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        T.make_train_step, C.conv3x3_weight_grad_reference = make_step, wgrad_reference
    # TRAIN_STEPS forwards and backwards, and the probe's DDS forwards (one save)
    check_counts(train_run_counts, TRAIN_STEPS + PROBE_DDS_STEPS, TRAIN_STEPS,
                 "the training run through the CLI", per_backward=train_pattern)
    if plain_wgrad[0]:
        raise AssertionError(f"the plain weight gradient ran {plain_wgrad[0]} times on CUDA")
    step_ms = [a.elapsed_time(b) for a, b in step_events]
    run_dir = os.path.join(workdir, "DiskEllipses", "vesde", "version_01")
    log_rows = [json.loads(line) for line in open(os.path.join(run_dir, "train_log.jsonl"))]
    cli_losses = [r["value"] for r in log_rows if r["name"] == "train/loss"]
    train_losses = [float(v) for v in step_losses]
    best = json.load(open(os.path.join(run_dir, "best_ema.json")))
    exported = F.load_params(os.path.join(run_dir, "best_ema.msgpack.npz"))
    mismatch = [n for n, v in state.ema.shadow.items()
                if not torch.equal(exported[n], v.detach().half().float().cpu())]
    # the probe's images and observation (val images 0 and 1, seed + 7): their FBP
    g = torch.Generator(device="cuda").manual_seed(config.seed + 7)
    _, _, fbp2 = F.get_data_from_ground_truth(images[:2], trafo, config.data.stddev, generator=g)
    fbp_psnr = float(np.mean([PSNR(fbp2[i, ..., 0].cpu().numpy(), images[i, ..., 0]) for i in range(2)]))
    probe_psnr = -float(best["score"])
    log(f"  train CLI: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} from {os.path.relpath(CKPT, REPO)} "
        f"(--lr_warmup {TRAIN_WARMUP}), {train_wall_s:.1f} s in the CLI; per step (CUDA events "
        f"around the trainer's step) " + ", ".join(f"{v:.1f}" for v in step_ms)
        + f" ms, median {np.median(step_ms):.1f} ms; device time of one step's loss forward "
        f"{train_fwd_dev:.2f} ms, forward + backward {train_both_dev:.2f} ms (graph replay); peak "
        f"memory {train_peak_gb:.2f} GiB")
    log("  loss per step: " + ", ".join(f"{v:.6e}" for v in train_losses) + "; the warm-start "
        "prior's on the same batch, t and z: " + ", ".join(f"{v:.6e}" for v in prior_losses)
        + "; ratios " + ", ".join(f"{a / b:.5f}" for a, b in zip(train_losses, prior_losses))
        + f" (at most {TRAIN_LOSS_RATIO})")
    log(f"  first loss: CLI {cli_losses[0]:.6e}, phase 9a with kernels {loss_k:.6e}; probe: "
        f"{PROBE_DDS_STEPS}-step DDS (eta 0.15) of val images 0 and 1 with the EMA shadow "
        f"{probe_psnr:.2f} dB vs FBP {fbp_psnr:.2f} dB; best_ema.msgpack.npz read back: "
        f"{len(exported)} leaves, {len(mismatch)} differ from the shadow in fp16")
    log("  launches in the training run: " + json.dumps(train_run_counts))
    if not (len(step_ms) == TRAIN_STEPS == len(train_losses)
            and all(math.isfinite(v) for v in cli_losses + train_losses)
            and abs(cli_losses[0] - loss_k) <= 1e-6 * abs(loss_k)
            and train_losses[0] == cli_losses[0]):
        raise AssertionError("the training run's steps or losses are off")
    if not all(a <= TRAIN_LOSS_RATIO * b for a, b in zip(train_losses, prior_losses)):
        raise AssertionError(f"a training step's loss exceeds {TRAIN_LOSS_RATIO} times the "
                             f"warm-start prior's: {train_losses} vs {prior_losses}")
    if mismatch or set(exported) != set(state.ema.shadow):
        raise AssertionError(f"best_ema.msgpack.npz differs from the EMA shadow: {mismatch[:5]}")
    if not probe_psnr > fbp_psnr:
        raise AssertionError(f"the keep-best probe's DDS {probe_psnr:.2f} dB does not beat FBP "
                             f"{fbp_psnr:.2f} dB")
    del state, exported

    # 9b'. the bf16 ties (printed, not gated): TRAIN_WITNESS_STEPS steps from the
    # masters the CLI starts from (rounded to bf16) and from masters left at the
    # checkpoint's fp16 values (an eighth of them halfway between two bf16
    # values); the probe of the EMA shadow, cast to bf16 as the JAX trainer
    # probes it (the fp32 witness was cut to keep the run inside its time
    # limit: PERF.md §4)
    def witness(cfg, rounded):
        if rounded:
            m, _, _ = F.get_standard_score(cfg, sde, ckpt_path=CKPT, train=True)
        else:
            m, _, _ = F.get_standard_score(cfg, sde, load_model=False, train=True)
            m.load_state_dict(F.load_params(CKPT))
        ps = dict(m.named_parameters())
        opt = T.Optimizer(ps, cfg.training.lr, TRAIN_WARMUP)
        st = T.TrainState(ps, opt, ema_init(ps), 0)
        step = T.make_train_step(m, sde, opt, cfg.training.ema_decay, cfg.training.ema_warm_start_steps)
        em, _, _ = F.get_standard_score(cfg, sde, load_model=False)
        probe = TRAIN_CLI._make_probe("dds", F, cfg, get_config, sde, em, torch.device("cuda"))
        start = []                  # this start's own loss on each step's batch, t and z
        _, bs = F.get_standard_train_dataset(cfg)
        with torch.no_grad():
            for k in range(TRAIN_WITNESS_STEPS):
                bk = next(bs)
                tk, zk = L.draw_time_and_noise(bk, sde, T.step_generator(cfg.seed, k, "cuda"))
                start.append(float(L.score_matching_loss(bk, m, sde, t=tk, z=zk)))
        _, bs = F.get_standard_train_dataset(cfg)
        out, probes = [], {}
        for k in range(TRAIN_WITNESS_STEPS):
            out.append(float(step(st, next(bs), T.step_generator(cfg.seed, k, "cuda"))))
            if k + 1 in (TRAIN_STEPS, TRAIN_WITNESS_STEPS):
                probes[k + 1] = -probe({n: v.to(torch.bfloat16) for n, v in st.ema.shadow.items()})
        return out, start, probes

    probe_steps, TRAIN_CLI.PROBE_DDS_STEPS = TRAIN_CLI.PROBE_DDS_STEPS, WITNESS_PROBE_STEPS
    try:
        for what, cfg, rounded in (("bf16, masters rounded to bf16 (the CLI's)", config, True),
                                   ("bf16, masters at the checkpoint's fp16 values", config, False)):
            w_losses, w_start, w_probes = witness(cfg, rounded)
            log(f"  {what}: loss per step " + ", ".join(f"{v:.6e}" for v in w_losses)
                + "; ratio to this start's loss on the same batch, t and z "
                + ", ".join(f"{a / b:.5f}" for a, b in zip(w_losses, w_start))
                + "; probe (" + f"{WITNESS_PROBE_STEPS}-step DDS) "
                + ", ".join(f"after {k} steps {v:.2f} dB" for k, v in w_probes.items())
                + f" (FBP {fbp_psnr:.2f} dB)")
            torch.cuda.empty_cache()
    finally:
        TRAIN_CLI.PROBE_DDS_STEPS = probe_steps

    # 9c. DDPM from the fresh init: the zero output of the init rule on the card, the epsilon loss
    dconfig = get_config("ddpm")
    dconfig.model.num_channels = 128
    dconfig.model.dtype = "bfloat16"
    fresh, _, _ = F.get_standard_score(dconfig, F.get_standard_sde(dconfig), load_model=False)
    with torch.no_grad():
        fresh_out = fresh(x, torch.full((1,), 500, dtype=torch.long, device="cuda"))
    if fresh_out.any():
        raise AssertionError("a fresh UNet does not output exactly zero on the card")
    del fresh
    argv = ["--sde", "ddpm", "--num_channels", "128", "--dtype", "bfloat16", "--epochs", "1",
            "--steps_per_epoch", str(DDPM_TRAIN_STEPS), "--base_path", workdir]
    reset_counts()
    TRAIN_CLI.coordinator(TRAIN_CLI.parser.parse_args(argv))
    ddpm_counts = read_counts()
    check_counts(ddpm_counts, DDPM_TRAIN_STEPS, DDPM_TRAIN_STEPS, "the DDPM training run",
                 per_backward=train_pattern)
    ddpm_dir = os.path.join(workdir, "DiskEllipses", "ddpm", "version_01")
    ddpm_losses = [json.loads(line)["value"] for line in open(os.path.join(ddpm_dir, "train_log.jsonl"))
                   if json.loads(line)["name"] == "train/loss"]
    log(f"  DDPM from the fresh init (output exactly 0 before training): {DDPM_TRAIN_STEPS} steps, "
        f"first epsilon loss {ddpm_losses[0]:.6e}; launches " + json.dumps(ddpm_counts))
    if not all(math.isfinite(v) for v in ddpm_losses):
        raise AssertionError("the DDPM training loss is not finite")
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"[phase 9 train] {time.perf_counter() - t0:.1f} s")

    # ---- 10. full and decoder adaptation: the full-width gradient, then short runs through the CLI
    t0 = time.perf_counter()
    from diffusion_models_dev_project_tpu_torch import run_adapted_sampling as ACLI
    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import is_adapt_param

    strategy_counts = {}
    calls = module_calls(model, x, torch.full((1,), 0.5, device="cuda"))
    # phase 5's observation of val image 0 and its noised state at t = 0.5
    g = torch.Generator(device="cuda").manual_seed(config.seed)
    _, obs, _ = F.get_data_from_ground_truth(images[0], trafo, config.data.stddev, generator=g)
    for impl in ("full", "decoder"):
        pattern = backward_pattern(calls, lambda name: is_adapt_param(name + ".weight", impl))
        m16, _, _ = F.get_standard_score(config, sde, ckpt_path=CKPT, adaptation=impl)
        m32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT, adaptation=impl)
        smp = {name: F.get_standard_adapted_sampler(
            "dds", m, sde, trafo, obs, num_steps=50, add_cg=True, cg_iter=1, dc_type="cg",
            tv_penalty=1e-6, lr=1e-3, adaptation=impl) for name, m in (("bf16", m16), ("fp32", m32))}
        reset_counts()
        loss_k, gk = adaptation_gradients(smp["bf16"], xg, tg, True)
        counts = read_counts()
        check_counts(counts, 1, 1, f"one forward and backward under {impl}", per_backward=pattern)
        loss_p, gp = adaptation_gradients(smp["bf16"], xg, tg, False)
        loss_32, g32 = adaptation_gradients(smp["fp32"], xg, tg, False)
        loss_32k, g32k = adaptation_gradients(smp["fp32"], xg, tg, True)
        del smp, m16, m32
        gradient_gates(gk, gp, g32, g32k, (loss_k, loss_p, loss_32, loss_32k),
                       f"adaptation loss gradient at 256², {impl}")
        del gk, gp, g32, g32k
        log(f"  launches of one forward and backward under {impl} (derived: "
            + json.dumps(pattern) + "): " + json.dumps(counts))
        argv = ["--load_path", CKPT, "--num_channels", "128", "--dtype", "bfloat16", "--adaptation",
                impl, "--num_steps", str(ADAPT_CLI_STEPS), "--num_optim_step", str(ADAPT_CLI_OPTIM),
                "--add_cg", "--num_images", "1"]
        cwd = os.getcwd()
        os.makedirs(workdir, exist_ok=True)
        os.chdir(workdir)
        try:
            reset_counts()
            ts = time.perf_counter()
            root = ACLI.coordinator(ACLI.parser.parse_args(argv))
            wall_s = time.perf_counter() - ts
            counts = read_counts()
            report = read_report(os.path.join(workdir, root, "report.yaml"))
            with np.load(os.path.join(workdir, root, "recon_0_info.npz")) as info:
                recon = info["recon"]
        finally:
            os.chdir(cwd)
        n = ADAPT_CLI_STEPS
        check_counts(counts, n * (ADAPT_CLI_OPTIM + 2) + 1, n * ADAPT_CLI_OPTIM,
                     f"the {impl} run through the adapted CLI", per_backward=pattern)
        if not (recon.shape == (256, 256) and np.isfinite(recon).all()):
            raise AssertionError(f"{impl}: the adapted CLI's reconstruction is not finite")
        strategy_counts[impl] = counts
        log(f"  {impl} through the adapted CLI ({n} x {ADAPT_CLI_OPTIM}, add_cg, test-fold image 0; a "
            f"shortened protocol, not gated): {report['PSNR']:.2f} dB / {report['SSIM']:.4f} SSIM, "
            f"{wall_s:.1f} s, {wall_s / n * 1e3:.0f} ms per outer step; launches " + json.dumps(counts))
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"[phase 10 full, decoder] {time.perf_counter() - t0:.1f} s")

    # ---- 10b. the adapted and train CLIs at their default compute dtype, fp32
    fp32_runs = fp32_defaults_phase(F, ACLI, TRAIN_CLI, T, calls, workdir, float(np.median(step_ms)))

    # ---- 11. several images per call: the per-image bias, conditional and adapted serving
    multi = multi_image_phase(F, P, CLI, ACLI, model, config, config32, sde, trafo, images, gen,
                              workdir, {"fwd": fwd_dev_ms, "cg": cg_dev_ms, "adapt_both": both_dev})
    shutil.rmtree(workdir, ignore_errors=True)

    # ---- 12, 12b. the walnut cone-beam protocol; 13. AAPM and the matrix operator
    model_args = (config, config32, sde, score_fn)
    walnut = walnut_phase(F, P, model_args, WALNUT_STEPS, gen)
    aapm = aapm_phase(F, P, model_args, AAPM_STEPS, gen, workdir)
    shutil.rmtree(workdir, ignore_errors=True)

    # ---- 14. the multi-card paths: training, conditional and adapted sampling sharded over ranks
    mc = multicard_phase(multi["one_card"], multicard_dir)

    # ---- 15. the 512² configuration and the evaluation entry points
    ph15 = phase_512_and_eval(F, P, gen, os.path.join(REPO, "build", "chip_smoke_512"))
    shutil.rmtree(os.path.join(REPO, "build", "chip_smoke_512"), ignore_errors=True)

    # ---- 16. kernel summary, device line
    src = "diffusion_models_dev_project_tpu_torch/csrc/"
    conv_src = {"tc": src + "conv3x3_tc.cu", "tf32x3": src + "conv3x3_tf32x3.cu",
                "narrow": src + "conv3x3.cu", "simt": src + "conv3x3.cu"}
    kernels = []
    for name, source, tot, err, launches, replaces, bwd in (
            ("conv3x3", conv_src["tc"], conv_tot, conv_err, conv_launches,
             "diffusion_models_dev_project_tpu/ops/conv3x3.py:35",
             (conv_src["tc"], conv_bwd_tot, conv_bwd_err, adapt_counts["conv_bwd"])),
            ("attention", src + "attention_mma.cu", attn_tot, attn_err, attn_launches,
             "diffusion_models_dev_project_tpu/ops/attention.py:43",
             (src + "attention_bwd_mma.cu", attn_bwd_tot, attn_bwd_err, adapt_counts["attn_bwd"]))):
        b_src, b_tot, b_err, b_launches = bwd
        fwd_key = "conv_fwd" if name == "conv3x3" else "attn_fwd"
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"],
            "launches_adapted": adapt_counts[fwd_key],    # forward launches of the adapted runs
            # per UNet backward; launches from the adapted runs
            "backward": {"source": b_src, "launches": b_launches, "ms": b_tot["ms"],
                         "plain_ms": b_tot["plain_ms"], "bound_ms": b_tot["bound_ms"],
                         "bound_by": "operations" if b_tot["ops_ms"] >= b_tot["bytes_ms"] else "bytes",
                         "library_ms": b_tot["library_ms"], "max_abs_err": b_err}})
    # launches of the DPS run through the CLI, forward and backward
    dps_counts = cli_runs["dps", "prior"]["counts"]
    for kern, (f_key, b_key) in zip(kernels, (("conv_fwd", "conv_bwd"), ("attn_fwd", "attn_bwd"))):
        kern["launches_dps"] = dps_counts[f_key]
        kern["backward"]["launches_dps"] = dps_counts[b_key]
    kernels[0]["backward"]["variants"] = {
        v: {"source": conv_src[v], "launches": adapt_counts["conv_bwd_by"][v],
            "launches_dps": dps_counts["conv_bwd_by"][v],
            "calls_per_backward": conv_bwd_variants.get(v, 0)} for v in C.VARIANTS}
    # the stem's input gradient (narrow), DPS's gradient in x only, per backward
    kernels[0]["backward"]["stem"] = {k: stem_bwd[k] for k in ("variant", "ms", "plain_ms",
                                                               "bound_ms", "library_ms")}
    # the weight gradient, per batch-3 training backward (the per-batch-1
    # times beside); launches from the training run through the CLI, then
    # per strategy through the adapted CLI
    w3, w1 = wgrad_tots[TRAIN_BATCH], wgrad_tots[1]
    wgrad_src = {v: src + {"tc": "conv3x3_wgrad_tc.cu", "tf32x3": "conv3x3_wgrad_tf32x3.cu"}.get(
        v, "conv3x3_wgrad.cu") for v in C.WGRAD_VARIANTS}
    kernels[0]["backward"]["weight_grad"] = {
        "name": "conv3x3_weight_grad", "route": "cuda", "source": wgrad_src["tc"],
        "replaces": "diffusion_models_dev_project_tpu/ops/conv3x3.py:35",
        "launches": train_run_counts["conv_wgrad"], "max_abs_err": wgrad_err, "ms": w3["ms"],
        "plain_ms": w3["plain_ms"], "bound_ms": w3["bound_ms"],
        "bound_by": "operations" if w3["ops_ms"] >= w3["bytes_ms"] else "bytes",
        "library_ms": w3["library_ms"], "batch": TRAIN_BATCH,
        "reduce_ms": w3["reduce_ms"],
        "batch1": {"ms": w1["ms"], "plain_ms": w1["plain_ms"], "bound_ms": w1["bound_ms"],
                   "library_ms": w1["library_ms"], "reduce_ms": w1["reduce_ms"]},
        "launches_ddpm": ddpm_counts["conv_wgrad"],
        "launches_full": strategy_counts["full"]["conv_wgrad"],
        "launches_decoder": strategy_counts["decoder"]["conv_wgrad"],
        "variants": {v: {"source": wgrad_src[v], "launches": train_run_counts["conv_wgrad_by"][v],
                         "calls_per_backward": wgrad_variants[TRAIN_BATCH].get(v, 0),
                         **{k: wgrad_tots.get((TRAIN_BATCH, v), {}).get(k, 0.0)
                            for k in ("ms", "plain_ms", "bound_ms", "library_ms", "reduce_ms")}}
                     for v in C.WGRAD_VARIANTS}}
    # attention backward: each variant's launches in the adapted runs and its
    # time per UNet backward at the path's shapes (simt: the earlier design)
    # (the fp32 route's tf32x3 has rows of its own below)
    attn_bwd_src = {"mma": src + "attention_bwd_mma.cu", "simt": src + "attention_bwd.cu"}
    attn_bwd_ms = {"mma": attn_bwd_tot["ms"], "simt": attn_bwd_tot["simt_ms"]}
    kernels[1]["backward"]["variants"] = {
        v: {"source": attn_bwd_src[v], "launches": adapt_counts["attn_bwd_by"][v],
            "calls_per_backward": attn_bwd_variants.get(v, 0), "ms": attn_bwd_ms[v],
            "bound_ms": attn_bwd_tot["bound_ms"], "library_ms": attn_bwd_tot["library_ms"]}
        for v in ("mma", "simt")}
    # the simt kernel at the shapes tc takes, per forward; each variant's share
    kernels[0]["simt_ms"] = conv_tot["simt_ms"]
    kernels[0]["variants"] = {
        v: {"source": conv_src[v], "launches": by_variant[v], "ms": agg["ms"],
            "bound_ms": agg["bound_ms"], "library_ms": agg["library_ms"]}
        for v, agg in conv_variants.items()}
    # attention: the simt kernel and the fastest SDPA backend at the
    # same inputs, per forward; each variant's share
    kernels[1]["simt_ms"] = attn_tot["simt_ms"]
    kernels[1]["library_best_ms"] = attn_tot["library_best_ms"]
    kernels[1]["library_best"] = attn_tot["library_best"]
    attn_ms = {"mma": attn_tot["ms"], "simt": attn_tot["simt_ms"]}
    kernels[1]["variants"] = {
        v: {"source": src + ("attention_mma.cu" if v == "mma" else "attention.cu"),
            "launches": attn_by_variant[v], "ms": attn_ms[v], "bound_ms": attn_tot["bound_ms"],
            "library_ms": attn_tot["library_ms"]}
        for v in ("mma", "simt")}
    # launches of the walnut DDS runs (cg and woodbury), and the AAPM UNet's
    # conv3x3 per forward (the 256-channel model)
    for kern, key in zip(kernels, ("conv_fwd", "attn_fwd")):
        kern["launches_walnut"] = sum(r["counts"][key] for r in walnut["dds"].values())
    # phase 11: the forward with a bias per image at batch 4, per UNet
    # forward; launches of the batched DDS and adapted runs
    bt = multi["bias_tot"]
    kernels[0]["per_image_bias"] = {
        "batch": SHARD_IMAGES, "max_abs_err": multi["bias_err"], "ms": bt["ms"],
        "plain_ms": bt["plain_ms"], "bound_ms": bt["bound_ms"],
        "bound_by": "operations" if bt["ops_ms"] >= bt["bytes_ms"] else "bytes",
        "library_ms": bt["library_ms"], "calls_by_variant": multi["bias_variants"],
        "launches_batched_dds": multi["dds_counts"]["conv_fwd"],
        "launches_batched_adapted": multi["adapted_counts"]["conv_fwd"]}
    kernels[1]["launches_batched_dds"] = multi["dds_counts"]["attn_fwd"]
    kernels[1]["launches_batched_adapted"] = multi["adapted_counts"]["attn_fwd"]
    # phase 14: the launches of the multi-card runs, per rank summed
    kernels[0]["launches_multicard"] = {k: mc["launches"][k]
                                        for k in ("conv_fwd", "conv_bwd", "conv_wgrad")}
    kernels[1]["launches_multicard"] = {k: mc["launches"][k] for k in ("attn_fwd", "attn_bwd")}
    kernels[0]["aapm_unet"] = dict(aapm["aapm_unet"]["conv"],
                                   launches=aapm["aapm_unet"]["counts"]["conv_fwd"],
                                   variants=aapm["aapm_unet"]["conv_variants"])
    # the fp32 route (phase 3's times per pass at the 60 tf32x3 shapes; the
    # launches of phase 10b's runs through the CLIs at their default dtype:
    # the adapted LoRA run, then the training run)
    c32, b32, w32 = conv_tot["fp32"], conv_bwd_tot["fp32"], wgrad_tots["fp32"]
    a32, t32 = fp32_runs["adapted", "float32"]["counts"], fp32_runs["train"]["counts"]

    def fp32_fields(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
                "library_ms": t["library_ms"], "simt_ms": t["simt_ms"],
                "fp32_cores_bound_ms": t["fp32_bound_ms"], "calls_per_pass": t["calls"]}
    kernels.append({
        "name": "conv3x3_tf32x3", "route": "cuda", "source": src + "conv3x3_tf32x3.cu",
        "replaces": "diffusion_models_dev_project_tpu/ops/conv3x3.py:35",
        "launches": a32["conv_fwd_by"]["tf32x3"], "max_abs_err": c32["max_abs"], **fp32_fields(c32),
        "launches_train": t32["conv_fwd_by"]["tf32x3"],
        "backward": {"launches": a32["conv_bwd_by"]["tf32x3"],
                     "launches_train": t32["conv_bwd_by"]["tf32x3"], "max_abs_err": b32["max_abs"],
                     **fp32_fields(b32)}})
    kernels.append({
        "name": "conv3x3_weight_grad_tf32x3", "route": "cuda",
        "source": src + "conv3x3_wgrad_tf32x3.cu",
        "replaces": "diffusion_models_dev_project_tpu/ops/conv3x3.py:35",
        "launches": t32["conv_wgrad_by"]["tf32x3"], "max_abs_err": w32["max_abs"],
        **fp32_fields(w32[TRAIN_BATCH]), "batch": TRAIN_BATCH, "batch1": fp32_fields(w32[1])})
    # the fp32 attention (phase 3's times per pass at batch 1, the training
    # batch's beside; the launches of phase 10b's adapted run, then of its
    # training run)
    for part, name, source, key in (
            ("forward", "attention_tf32x3", "attention_tf32x3.cu", "attn_fwd_by"),
            ("backward", "attention_backward_tf32x3", "attention_bwd_tf32x3.cu", "attn_bwd_by")):
        one, train = attn_fp32[1][part], attn_fp32[TRAIN_BATCH][part]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": "diffusion_models_dev_project_tpu/ops/attention.py:43",
            "launches": a32[key]["tf32x3"], "max_abs_err": max(one["max_abs_err"],
                                                               train["max_abs_err"]),
            **fp32_fields(dict(one, calls=len(seen["attn"]))),
            "launches_train": t32[key]["tf32x3"],
            "batch_train": dict(fp32_fields(dict(train, calls=len(seen["attn"]))),
                                batch=TRAIN_BATCH)})
    # heads past 128 (phase 3's rows; per UNet pass at phase 5b's calls, its launches)
    kernels.extend(wide_kernel_rows(attn_wide, wide_unet, src))
    kernels.extend(kernel_rows_512(ph15))
    log(f"(kernel times are per UNet forward: the sum over its calls at their shapes; "
        f"whole run {time.perf_counter() - t_all:.1f} s)")
    log(smi.splitlines()[0])                # the card again, for readers of the output's tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
