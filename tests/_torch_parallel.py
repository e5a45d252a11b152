"""Torch halves of tests/test_torch_parallel.py: the port's three sharded
paths on two gloo ranks on the CPU (`parallel/launch.py::launch`).

`python tests/_torch_parallel.py <case> in.npz out.npz` runs a case
(tests/_torch_child.py).  The case starts its ranks with the `spawn`
start method, which imports the parent's main script in every rank: so
the cases live here, in a module that imports numpy alone at its top and
no JAX, and not in the test file, whose JAX half would load in each rank.
Each case runs the one-process path too, and returns both.
"""
import os
import sys
import time

import numpy as np

import _torch_child as child

RANKS = ["cpu", "cpu"]
GROUP_TIMEOUT_S = 60.0         # a collective that waits longer raises in its rank
# (b) training: 3 steps at a global batch of 4 (2 rows a rank), the first at
# the warmup's lr 0; the EMA copies for 2 steps, then averages
TRAIN_STEPS, TRAIN_BATCH, TRAIN_CHANNELS = 3, 4, 64
LR, WARMUP, EMA_DECAY, EMA_WARM, SIGMA_ALPHA, HEAD_CHANNELS = 1e-3, 1, 0.99, 2, 0.5, 8
CLIP = 1.0          # far below the gradient norms of these losses (about 1e3): it binds
# (c) conditional sampling: 4 images, each case a chain of N_STEPS
N_IMAGES, N_STEPS, PENALTY = 4, 4, 2.0
CHAIN_CASES = {
    "dds": ("dds", {"eta": 0.85, "cg_iter": 3}),
    # DPS's data fit and the corrector's step size take norms over the whole batch
    "dps_corrector": ("dps", {"add_corrector_step": True}),
}
JAX_CHAIN_CASES = ("dds",)      # also held to the JAX mesh
# (d) adapted sampling, `lora`: 4 images, each with its own LoRA state
LORA_RANK, ADAPT_STEPS, ADAPT_OPTIM, ADAPT_FREQ = 2, 3, 2, 2
ADAPT_KW = dict(add_cg=True, cg_iter=1, dc_type="cg", eta=0.85, gamma=0.01, tv_penalty=1e-6,
                lr=1e-3)


def _gather_objects(obj):
    """Every rank's `obj`, in rank order (rank 0 returns them)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ------------------------------------------------------------- (a) mesh helpers
def _rank_mesh_helpers(x):
    import torch

    from diffusion_models_dev_project_tpu_torch.parallel import mesh as M

    m = M.make_mesh(device="cpu")
    x = torch.from_numpy(x)
    out = {"rank": m.rank, "world": m.world, "shape": m.shape}
    out["shard"] = M.shard_batch(m, x).numpy()
    out["gather"] = M.gather_batch(m, 2 * M.shard_batch(m, x)).numpy()
    out["replicate"] = M.replicate(m, torch.full((3,), 10.0 + m.rank)).numpy()
    ts = [torch.full((2, 3), float(m.rank + 1)), torch.full((4,), 3.0 * m.rank)]
    M.all_reduce_mean_(m, ts)
    out["mean"] = [t.numpy() for t in ts]
    v = torch.tensor(1.0 + m.rank, requires_grad=True)
    total = M.all_reduce_sum(m, v * v)
    total.backward()
    out["sum"], out["sum_grad"] = float(total), float(v.grad)
    try:
        M.shard_batch(m, x[:3])
        out["odd"] = ""
    except ValueError as e:
        out["odd"] = str(e)
    return _gather_objects(out)


def mesh_helpers(x):
    import torch

    from diffusion_models_dev_project_tpu_torch.parallel import mesh as M
    from diffusion_models_dev_project_tpu_torch.parallel.launch import launch

    ranks = launch(_rank_mesh_helpers, RANKS, "gloo", x, timeout_s=GROUP_TIMEOUT_S)
    out = {}
    for r, res in enumerate(ranks):
        assert res["rank"] == r and res["world"] == 2 and res["shape"] == {"data": 2}
        out[f"shard_{r}"], out[f"gather_{r}"] = res["shard"], res["gather"]
        out[f"replicate_{r}"] = res["replicate"]
        out[f"mean_a_{r}"], out[f"mean_b_{r}"] = res["mean"]
        out[f"sum_{r}"] = np.array([res["sum"], res["sum_grad"]])
        out[f"odd_{r}"] = np.array(res["odd"])
    # outside a group: one device, and a mesh over two raises
    one = M.make_mesh(device="cpu")
    assert one.world == 1 and one.shape == {"data": 1} and one.devices == (torch.device("cpu"),)
    assert np.array_equal(M.shard_batch(one, torch.from_numpy(x)).numpy(), x)
    try:
        M.make_mesh(2, device="cpu")
        out["two_outside"] = np.array("")
    except ValueError as e:
        out["two_outside"] = np.array(str(e))
    return out


# ------------------------------------------------------------- (b) training
def _train(arrays, batches, ts, zs, mesh):
    """The steps of the tiny UNet from the JAX weights on the given batches
    and draws; (params, EMA, losses and gradient norms, the parameters)."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax
    from diffusion_models_dev_project_tpu_torch.parallel.mesh import shard_batch
    from diffusion_models_dev_project_tpu_torch.training import trainer as T
    from diffusion_models_dev_project_tpu_torch.training.ema import ema_init

    c = tiny(get_config, "vesde", TRAIN_CHANNELS)
    sde = TF.get_standard_sde(c)
    model, _, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu", train=True)
    model.load_state_dict(params_from_flax(child.unflatten(arrays, "params/")), strict=True)
    params = dict(model.named_parameters())
    opt = T.Optimizer(params, LR, WARMUP, CLIP)
    norms, clip_ = [], opt.clip_
    opt.clip_ = lambda grads: norms.append(clip_(grads)) or norms[-1]
    state = T.TrainState(params, opt, ema_init(params), 0)
    step = T.make_train_step(lambda x, t: model(x, t), sde, opt, EMA_DECAY, EMA_WARM,
                             loss_kwargs={"sigma_alpha": SIGMA_ALPHA}, mesh=mesh)
    losses = []
    for b, t, z in zip(batches, ts, zs):
        b, t, z = (torch.from_numpy(a) for a in (b, t, z))
        if mesh is not None:
            b, t, z = shard_batch(mesh, (b, t, z))
        losses.append(step(state, b, t=t, z=z))
    out = {"losses": torch.stack(losses).numpy(), "norms": torch.stack(norms).numpy()}
    for n, p in params.items():
        out[f"p/{n}"], out[f"ema/{n}"] = p.detach().numpy(), state.ema.shadow[n].numpy()
    return out, params


def _rank_train(arrays, batches, ts, zs):
    import torch
    import torch.distributed as dist

    from diffusion_models_dev_project_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    out, params = _train(arrays, batches, ts, zs, mesh)
    # the replicas bitwise: rank 0's bits against this rank's
    bits = torch.cat([p.detach().reshape(-1) for p in params.values()]).view(torch.int32)
    ref = bits.clone()
    dist.broadcast(ref, src=0)
    equal = torch.tensor([int(torch.equal(bits, ref))])
    dist.all_reduce(equal, op=dist.ReduceOp.MIN)
    out["replicas_equal"] = np.array(bool(equal.item()))
    return out


def train(batches, ts, zs, **arrays):
    from diffusion_models_dev_project_tpu_torch.parallel.launch import launch

    one, _ = _train(arrays, batches, ts, zs, None)
    two = launch(_rank_train, RANKS, "gloo", arrays, batches, ts, zs, timeout_s=GROUP_TIMEOUT_S)
    return {**{f"one/{k}": v for k, v in one.items()}, **{f"two/{k}": v for k, v in two.items()}}


# ------------------------------------------------------------- (c) conditional sampling
def _chains(gt, obs, fbp, arrays, mesh):
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    weights = params_from_flax(child.unflatten(arrays, "params/"))
    T = torch.from_numpy
    out = {}
    for case, (method, kw) in CHAIN_CASES.items():
        c = tiny(get_config, "vesde")
        sde = TF.get_standard_sde(c)
        model, _, score = TF.get_standard_score(c, sde, load_model=False, device="cpu")
        model.load_state_dict(weights)
        trafo = TF.get_standard_ray_trafo(c, device="cpu")
        sampler = TF.get_standard_sampler(
            method, score, sde, trafo, T(obs), num_steps=N_STEPS,
            batch_size=gt.shape[0], im_shape=gt.shape[1:], penalty=PENALTY,
            ground_truth=T(gt), filtbackproj=T(fbp), device="cpu", **kw)
        x, trace = sampler.sample(noises=list(T(arrays[f"noises_{case}"])), return_trace=True,
                                  mesh=mesh)
        out[f"x_{case}"], out[f"trace_{case}"] = x.numpy(), trace.numpy()
    return out


def _rank_chains(gt, obs, fbp, arrays):
    from diffusion_models_dev_project_tpu_torch.parallel.mesh import make_mesh

    return _chains(gt, obs, fbp, arrays, make_mesh(device="cpu"))


def chains(gt, obs, fbp, **arrays):
    from diffusion_models_dev_project_tpu_torch.parallel.launch import launch

    one = _chains(gt, obs, fbp, arrays, None)
    two = launch(_rank_chains, RANKS, "gloo", gt, obs, fbp, arrays, timeout_s=GROUP_TIMEOUT_S)
    return {**{f"one/{k}": v for k, v in one.items()}, **{f"two/{k}": v for k, v in two.items()}}


# ------------------------------------------------------------- (d) adapted sampling
def _batched(obs, noises, arrays, mesh):
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import lora_from_flax, params_from_flax

    c = tiny_adapted(get_config)
    sde = TF.get_standard_sde(c)
    model, _, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu",
                                        lora_rank=LORA_RANK)
    model.load_state_dict(params_from_flax(child.unflatten(arrays, "params/")), strict=False)
    trafo = TF.get_standard_ray_trafo(c, device="cpu")
    obs, noises = torch.from_numpy(obs), torch.from_numpy(noises)
    loras = [lora_from_flax(child.unflatten(arrays, f"lora{j}/")) for j in range(len(obs))]
    stack = {k: torch.stack([lo[k] for lo in loras]) for k in loras[0]}
    sampler = TF.get_standard_adapted_sampler(
        "dds", model, sde, trafo, obs[0], num_steps=ADAPT_STEPS, num_optim_step=ADAPT_OPTIM,
        adapt_freq=ADAPT_FREQ, lora_rank=LORA_RANK, **ADAPT_KW)
    return {"x": sampler.sample_batched(obs, noises=noises, lora_stack=stack, mesh=mesh).numpy()}


def _rank_batched(obs, noises, arrays):
    from diffusion_models_dev_project_tpu_torch.parallel.mesh import make_mesh

    return _batched(obs, noises, arrays, make_mesh(device="cpu"))


def batched(obs, noises, **arrays):
    from diffusion_models_dev_project_tpu_torch.parallel.launch import launch

    one = _batched(obs, noises, arrays, None)
    two = launch(_rank_batched, RANKS, "gloo", obs, noises, arrays, timeout_s=GROUP_TIMEOUT_S)
    return {"one": one["x"], "two": two["x"]}


# ------------------------------------------------------------- (e) a failing rank
def _rank_fails(seconds):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 stops here")
    dist.barrier()                   # rank 0 waits for a rank that never comes
    time.sleep(seconds)


def failing_rank():
    import multiprocessing

    from diffusion_models_dev_project_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    try:
        launch(_rank_fails, RANKS, "gloo", 300.0, timeout_s=GROUP_TIMEOUT_S)
        message = ""
    except RuntimeError as e:
        message = str(e)
    seconds = time.perf_counter() - t0
    left = len(multiprocessing.active_children())
    try:
        launch(_rank_fails, ["cuda:0", "cuda:0"], "nccl", 0.0)
        nccl = ""
    except ValueError as e:          # raised before any rank starts
        nccl = str(e)
    return {"message": np.array(message), "seconds": np.array(seconds), "left": np.array(left),
            "nccl": np.array(nccl)}


# ------------------------------------------------------------- configs
def tiny(get_config, sde, channels=32):
    """The tiny flagship UNet of tests/_torch_chains.py (32², 32 channels,
    two levels, attention in the middle block with heads of
    `HEAD_CHANNELS`).  Training takes
    `TRAIN_CHANNELS`: with one channel per GroupNorm group, a conv bias
    right before a GroupNorm has a gradient of exactly 0."""
    c = get_config(sde)
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = channels
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = HEAD_CHANNELS
    c.forward_op.num_angles = 20
    return c


def tiny_adapted(get_config):
    """The tiny LoRA UNet of tests/test_torch_sample_batched.py."""
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 64
    c.model.channel_mult = "1"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child.main(globals())
