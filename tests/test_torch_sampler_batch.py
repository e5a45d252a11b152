"""The port's engine at batch 2 against the JAX engine at `batch_size=2`.

Two phantoms' observations and FBPs stacked on the sampler's batch axis, as
the conditional CLI's `--shard_images` stacks them: DDS with CG and with the
exact Woodbury solve (the parallel-beam operator as a dense matrix), naive, DPS and
unconditional sampling on VESDE, and ancestral DPS on DDPM, each a whole
chain of `N_STEPS` steps through `factory.get_standard_sampler` on both
sides with the JAX engine's (2, 32, 32, 1) draws injected.  The returned
chain must lie within `TOL` = 1e-4 of max|JAX|, and the PSNR trace, which
both engines keep on image 0, within `TOL_TRACE_DB` of JAX's
(tests/_torch_chains.py).

The torch half runs in one child interpreter for all cases
(tests/_torch_child.py): no pytest process runs torch code.
"""
import pytest

import _torch_chains as chain_cases

CASES = {
    "dds_cg_vesde": ("dds", "vesde", {"eta": 0.85, "cg_iter": 3}),
    "dds_woodbury_vesde": ("dds", "vesde", {"eta": 0.85, "dc_mode": "woodbury", "dense": True}),
    "naive_vesde": ("naive", "vesde", {}),
    "dps_vesde": ("dps", "vesde", {}),
    "uncond_vesde": ("uncond", "vesde", {}),
    "ancestral_dps_ddpm": ("dps", "ddpm", {}),
}
CONDITIONAL = [c for c, (method, _, _) in CASES.items() if method != "uncond"]


def chains(gt, obs, fbp, **arrays):
    return chain_cases.chains(CASES, gt, obs, fbp, arrays)


if __name__ == "__main__":
    chain_cases.child.main(globals())


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return chain_cases.jax_half(__file__, CASES, tmp_path_factory.mktemp("batch"), seed=71,
                                batch=2)


@pytest.mark.parametrize("case", list(CASES))
def test_batch2_chain_matches_jax(pair, case):
    refs, out = pair
    assert refs[f"x_{case}"].shape == (2, 32, 32, 1)
    chain_cases.check_chain(pair, case)


@pytest.mark.parametrize("case", CONDITIONAL)
def test_batch2_psnr_trace_matches_jax(pair, case):
    chain_cases.check_trace(pair, case)
