"""The port's three sharded paths on two ranks against the JAX package's mesh.

The torch half of each case runs two gloo ranks on the CPU through
`parallel/launch.py::launch`, in a child interpreter
(tests/_torch_parallel.py, which also runs the one-process path); the JAX
half shards the same work over `make_mesh(2)`, two of the suite's eight
virtual CPU devices (tests/conftest.py).  Both sides compute in fp32.

(a) the mesh helpers: each rank's rows are the rows JAX's `shard_batch`
    puts on its device; `gather_batch`, `replicate`, `all_reduce_mean_` and
    `all_reduce_sum` (its gradient too) on two ranks, exactly; a batch that
    the ranks do not divide, and a mesh over two devices outside a group,
    raise.
(b) 3 training steps of the tiny flagship UNet at a global batch of 4 over
    2 ranks, with the JAX draws of t and z and a global-norm clip that
    binds: the two replicas bitwise equal; against the one-process run at
    batch 4, the gradient norms (after the all-reduce, before the clip) at
    rtol 1e-6 and every leaf within
    `TOL_ONE_PROCESS` = 1e-6 of its 2-norm (losses rtol 1e-6); against
    JAX's `make_train_step` on the 2-device mesh with the bounds of
    tests/test_torch_train_step.py.  The key third of each attention `qkv`
    bias has a gradient of exactly 0 (a constant added to a softmax row);
    Adam turns its rounding noise into steps of up to lr on any two
    correct runs, so those elements are held to 2 lr k only.
(c) DDS, 4 images over 2 ranks with the JAX draws injected, against JAX's
    `sample(mesh=make_mesh(2))` within `TOL_CHAIN` = 1e-4 of max|JAX| and
    the PSNR trace within 2e-3 dB (tests/_torch_chains.py's bounds); it
    and DPS with the Langevin corrector (whose data fit and step size take
    norms over the whole batch: all-reduced) against the one-process run
    at batch 4 within `TOL_ONE_PROCESS` of max|x|, the trace within 2e-3
    dB.  (tests/test_torch_sampler_batch.py holds one-process DPS to JAX.)
(d) `sample_batched` under `lora`, 4 images each with its own LoRA state
    and draws, over 2 ranks: against JAX's `sample_batched(mesh=...)` within
    `TOL_CHAIN` of max|JAX| (tests/test_torch_sample_batched.py's bound);
    against the one-process batched run within `TOL_ONE_PROCESS` of max|x|.
(e) a `launch` in which rank 1 raises while rank 0 waits in a barrier
    fails in the caller within `FAIL_SECONDS`, naming the rank and its
    error, and leaves no process behind; two NCCL ranks on one card are
    refused before any starts.
"""
import os

import numpy as np

import _torch_child as child
import _torch_parallel as tp

HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_parallel.py")
TOL_ONE_PROCESS = 1e-6
TOL_CHAIN = 1e-4
TOL_TRACE_DB = 2e-3
TOL_LOSS_JAX, TOL_LOSS_JAX_AFTER = 1e-5, 1e-4      # tests/test_torch_train_step.py
STEP_FRACTION, OUTLIERS = 1e-2, 1e-4                 # the same file's bounds after k steps
FAIL_SECONDS = 30.0

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.models import unet as JU  # noqa: E402
from diffusion_models_dev_project_tpu.parallel.mesh import make_mesh, replicate, shard_batch  # noqa: E402
from diffusion_models_dev_project_tpu.physics.simulation import simulate as j_simulate  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import adaptation as ja  # noqa: E402
from diffusion_models_dev_project_tpu.training.ema import ema_init as j_ema_init  # noqa: E402
from diffusion_models_dev_project_tpu.training.trainer import TrainState, make_train_step  # noqa: E402
from _torch_chains import _engine_draws  # noqa: E402


def _draw_params(shapes, seed):
    """Every leaf drawn nonzero (scales about 1), so that the layers JAX
    initialises at zero carry gradient too."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(shapes)
    return traverse_util.unflatten_dict({
        path: (float(path[-1] == "scale") + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
        for path, leaf in flat.items()})


def _port_layout(tree):
    """name -> array of a params-shaped JAX tree in the port's layout."""
    out = {}
    for path, a in traverse_util.flatten_dict(tree).items():
        a = np.asarray(a)
        if path[-1] == "kernel" and a.ndim == 2:
            a = a.T
        elif path[-1] == "kernel" and a.shape[:2] == (1, 1):
            a = a.reshape(a.shape[2:]).T
        *mods, leaf = path
        out[".".join([*mods, "weight" if leaf in ("kernel", "scale") else "bias"])] = a
    return out


def _zero_gradient(name, shape):
    """The elements whose gradient is exactly 0: the key third of an
    attention `qkv` bias ([head][q|k|v][ch] order)."""
    mask = np.zeros(shape, bool)
    if name.endswith(".qkv.bias"):
        mask.reshape(-1, 3, tp.HEAD_CHANNELS)[:, 1] = True
    return mask


# ------------------------------------------------------------- (a)
def test_mesh_helpers_on_two_ranks_match_the_jax_mesh(tmp_path):
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    pending = child.start(HELPER, "mesh_helpers", tmp_path, x=x)
    mesh = make_mesh(2)
    shards = {list(mesh.devices.flat).index(s.device): np.asarray(s.data)
              for s in shard_batch(mesh, jnp.asarray(x)).addressable_shards}
    out = pending.result()
    for r in range(2):
        np.testing.assert_array_equal(out[f"shard_{r}"], shards[r])
        np.testing.assert_array_equal(out[f"gather_{r}"], 2 * x)
        np.testing.assert_array_equal(out[f"replicate_{r}"], np.full(3, 10.0))     # rank 0's
        np.testing.assert_array_equal(out[f"mean_a_{r}"], np.full((2, 3), 1.5))
        np.testing.assert_array_equal(out[f"mean_b_{r}"], np.full(4, 1.5))
        # 1² + 2², and d/dv of it through this rank's term: 2 v
        np.testing.assert_array_equal(out[f"sum_{r}"], [5.0, 2.0 * (1 + r)])
        assert "does not divide" in str(out[f"odd_{r}"])
    assert "one process per device" in str(out["two_outside"])


# ------------------------------------------------------------- (b)
def test_data_parallel_steps_match_one_process_and_the_jax_mesh(tmp_path):
    jc = tp.tiny(jget, "vesde", tp.TRAIN_CHANNELS)
    jmodel = JU.UNetModel(JU.create_model_config(jc.model))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
                            jnp.zeros((1,)))["params"]
    params = _draw_params(shapes, 61)
    sde = JF.get_standard_sde(jc)
    apply = lambda p, x, t: jmodel.apply({"params": p}, x, t)      # noqa: E731
    rng = np.random.default_rng(62)
    batches = rng.uniform(0, 1, (tp.TRAIN_STEPS, tp.TRAIN_BATCH, 32, 32, 1)).astype(np.float32)
    key, subs, draws = jax.random.PRNGKey(63), [], []
    for b in batches:
        key, sub = jax.random.split(key)
        kt, kz = jax.random.split(sub)          # the draws of score_matching_loss(sub, ...)
        t = jax.random.uniform(kt, (b.shape[0],)) * (1.0 - 1e-5) + 1e-5
        subs.append(sub)
        draws.append((np.asarray(t), np.asarray(jax.random.normal(kz, b.shape, jnp.float32))))
    pending = child.start(HELPER, "train", tmp_path, timeout=180, batches=batches,
                          ts=np.stack([d[0] for d in draws]), zs=np.stack([d[1] for d in draws]),
                          **child.flatten(params, "params/"))
    opt = optax.chain(optax.clip_by_global_norm(tp.CLIP),
                      optax.adam(optax.linear_schedule(0.0, tp.LR, tp.WARMUP)))
    mesh = make_mesh(2)
    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    state = replicate(mesh, TrainState(p0, opt.init(p0), j_ema_init(p0), jnp.zeros((), jnp.int32)))
    step_fn = make_train_step(apply, sde, opt, tp.EMA_DECAY, tp.EMA_WARM,
                              loss_kwargs={"sigma_alpha": tp.SIGMA_ALPHA})
    losses = []
    for b, sub in zip(batches, subs):
        state, loss = step_fn(state, shard_batch(mesh, jnp.asarray(b)), sub)
        losses.append(float(loss))
    out = pending.result()
    k = tp.TRAIN_STEPS

    assert bool(out["two/replicas_equal"])
    assert out["one/norms"].min() > 2 * tp.CLIP          # the clip binds at every step
    np.testing.assert_allclose(out["two/norms"], out["one/norms"], rtol=TOL_ONE_PROCESS)
    np.testing.assert_allclose(out["two/losses"], out["one/losses"], rtol=TOL_ONE_PROCESS)
    names = [key[len("one/p/"):] for key in out if key.startswith("one/p/")]
    for tag in ("p", "ema"):
        for name in names:
            got, ref = out[f"two/{tag}/{name}"], out[f"one/{tag}/{name}"]
            mask = _zero_gradient(name, ref.shape)
            assert np.abs(got - ref)[mask].max(initial=0) <= 2 * tp.LR * k, (tag, name)
            d = np.where(mask, 0.0, got - ref)
            assert np.linalg.norm(d) <= TOL_ONE_PROCESS * np.linalg.norm(ref), (tag, name)

    # against the JAX mesh, as tests/test_torch_train_step.py holds one card
    np.testing.assert_allclose(out["two/losses"][0], losses[0], rtol=TOL_LOSS_JAX)
    np.testing.assert_allclose(out["two/losses"], losses, rtol=TOL_LOSS_JAX_AFTER)
    start = _port_layout(params)
    for tag, tree in (("p", state.params), ("ema", state.ema.shadow)):
        far = total = 0
        for name, ref in _port_layout(tree).items():
            d = np.abs(out[f"two/{tag}/{name}"] - ref)
            assert d.max() <= 2 * tp.LR * k, (tag, name)
            d = d[~_zero_gradient(name, d.shape)]
            far += int(np.sum(d > STEP_FRACTION * tp.LR))
            total += d.size
        assert far <= OUTLIERS * total, (tag, far, total)
    # not vacuous: the steps after the warmup's first moved the parameters by about lr
    assert max(np.abs(out[f"two/p/{n}"] - start[n]).max() for n in start) > 0.5 * tp.LR


# ------------------------------------------------------------- (c)
def test_sharded_conditional_sampling_matches_one_process_and_the_jax_mesh(tmp_path):
    jc = tp.tiny(jget, "vesde")
    sde = JF.get_standard_sde(jc)
    jmodel, params, _ = JF.get_standard_score(jc, sde, load_model=False)
    rng = np.random.default_rng(71)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    trafo = JF.get_standard_ray_trafo(jc)
    gt = np.zeros((tp.N_IMAGES, 32, 32, 1), np.float32)
    for i in range(tp.N_IMAGES):
        gt[i, 4 + 2 * i:20, 6:22 - i, 0] = 1.0 - 0.15 * i
        gt[i, 22:29, 3 + 3 * i:14 + i, 0] = 0.5
    _, obs, fbp = JF.get_data_from_ground_truth(jnp.asarray(gt), trafo, 0.01,
                                                jax.random.PRNGKey(72))
    samplers, noises = {}, {}
    for i, (case, (method, kw)) in enumerate(tp.CHAIN_CASES.items()):
        key = jax.random.PRNGKey(73 + i)
        sampler = JF.get_standard_sampler(
            method, None, sde, trafo, obs, num_steps=tp.N_STEPS, batch_size=tp.N_IMAGES,
            im_shape=gt.shape[1:], penalty=tp.PENALTY, ground_truth=jnp.asarray(gt),
            filtbackproj=fbp, score_apply=lambda p, x, t: jmodel.apply({"params": p}, x, t),
            score_params=params, cg_precision="highest", **kw)
        if case in tp.JAX_CHAIN_CASES:
            samplers[case] = (sampler, key)
        noises[f"noises_{case}"] = _engine_draws(key, tp.N_STEPS, sampler.spec.corrector_steps,
                                                 gt.shape)
    pending = child.start(HELPER, "chains", tmp_path, timeout=180, gt=gt, obs=np.asarray(obs),
                          fbp=np.asarray(fbp), **noises, **child.flatten({"params": params}))
    mesh = make_mesh(2)
    refs = {}
    for case, (sampler, key) in samplers.items():
        x, trace = sampler.sample(key, return_trace=True, mesh=mesh)
        refs[case] = (np.asarray(x), np.asarray(trace))
    out = pending.result()
    for case in tp.CHAIN_CASES:
        two, one = out[f"two/x_{case}"], out[f"one/x_{case}"]
        assert two.shape == (tp.N_IMAGES, 32, 32, 1) and np.isfinite(two).all()
        assert np.abs(two - one).max() <= TOL_ONE_PROCESS * np.abs(one).max(), case
        assert np.abs(out[f"two/trace_{case}"] - out[f"one/trace_{case}"]).max() <= TOL_TRACE_DB
        # the images did not run one chain twice
        assert np.abs(one[0] - one[2]).max() > 100 * TOL_CHAIN * np.abs(one).max()
    for case, (ref, ref_trace) in refs.items():
        two = out[f"two/x_{case}"]
        err = np.abs(two - ref).max() / np.abs(ref).max()
        assert err <= TOL_CHAIN, f"{case}: {err:.3e} of max|JAX|"
        assert np.abs(out[f"two/trace_{case}"] - ref_trace).max() <= TOL_TRACE_DB, case


# ------------------------------------------------------------- (d)
def test_sharded_adapted_sampling_matches_one_process_and_the_jax_mesh(tmp_path):
    jc = tp.tiny_adapted(jget)
    jsd = JF.get_standard_sde(jc)
    import dataclasses

    cfg = dataclasses.replace(JU.create_model_config(jc.model), lora_rank=tp.LORA_RANK)
    jmodel = JU.UNetModel(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jmodel.init, {"params": key, "lora": key},
                            jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,)))
    params = _draw_params(shapes["params"], 81)
    loras = [_draw_params(shapes["lora"], 82 + j) for j in range(tp.N_IMAGES)]
    gt = np.zeros((tp.N_IMAGES, 1, 32, 32, 1), np.float32)
    for i in range(tp.N_IMAGES):
        gt[i, 0, 5 + i:21, 9 - i:23, 0] = 1.0 - 0.2 * i
        gt[i, 0, 23:29, 4 + 2 * i:13, 0] = 0.5
    trafo = JF.get_standard_ray_trafo(jc)
    obs = np.stack([np.asarray(j_simulate(jax.random.PRNGKey(90 + j), jnp.asarray(gt[j]), trafo,
                                          0.01)) for j in range(tp.N_IMAGES)])
    keys = jnp.stack([jax.random.PRNGKey(95 + j) for j in range(tp.N_IMAGES)])

    def image_draws(k):
        """The single-image program's draws: the prior's, then one per outer step."""
        k, init_key = jax.random.split(k)
        out = [np.asarray(jax.random.normal(init_key, gt.shape[1:]))]
        for _ in range(tp.ADAPT_STEPS):
            k, sub = jax.random.split(k)
            out.append(np.asarray(jax.random.normal(sub, gt.shape[1:], jnp.float32)))
        return np.stack(out)

    noises = np.stack([image_draws(k) for k in keys])
    arrays = {**child.flatten(params, "params/"),
              **{k: v for j, lo in enumerate(loras) for k, v in child.flatten(lo, f"lora{j}/").items()}}
    pending = child.start(HELPER, "batched", tmp_path, timeout=180, obs=obs, noises=noises, **arrays)
    sampler = ja.get_standard_adapted_sampler(
        "dds", jmodel, params, jsd, trafo, jnp.asarray(obs[0]), num_steps=tp.ADAPT_STEPS,
        num_optim_step=tp.ADAPT_OPTIM, adapt_freq=tp.ADAPT_FREQ, lora_rank=tp.LORA_RANK,
        **tp.ADAPT_KW)
    stack = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *loras)
    ref = np.asarray(sampler.sample_batched(keys, jnp.asarray(obs), mesh=make_mesh(2),
                                            lora_stack=stack))
    out = pending.result()
    two, one = out["two"], out["one"]
    assert two.shape == ref.shape == (tp.N_IMAGES, 1, 32, 32, 1) and np.isfinite(two).all()
    err = np.abs(two - ref).max() / np.abs(ref).max()
    assert err <= TOL_CHAIN, f"{err:.3e} of max|JAX|"
    assert np.abs(two - one).max() <= TOL_ONE_PROCESS * np.abs(one).max()
    assert np.abs(ref[0] - ref[2]).max() > 100 * TOL_CHAIN * np.abs(ref).max()


# ------------------------------------------------------------- (e)
def test_a_failing_rank_fails_the_launch_and_leaves_no_process(tmp_path):
    out = child.run(HELPER, "failing_rank", tmp_path)
    message = str(out["message"])
    assert "rank 1 of 2 failed" in message and "rank 1 stops here" in message, message
    assert float(out["seconds"]) < FAIL_SECONDS
    assert int(out["left"]) == 0
    assert "NCCL takes one rank per card" in str(out["nccl"])

