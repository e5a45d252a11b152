"""The port's ancestral DPS on DDPM and unconditional chains against the JAX engine.

Ancestral DPS on the DDPM prior, and unconditional sampling on both
families (Euler-Maruyama for VESDE, DDIM for DDPM): whole chains of
`N_STEPS` steps through `factory.get_standard_sampler` on both sides, and
the ancestral chain's per-step PSNR trace.  How the two sides are fed and
compared, and the tolerances, are in tests/_torch_chains.py.

The torch half runs in one child interpreter for all cases
(tests/_torch_child.py): no pytest process runs torch code.
"""
import pytest

import _torch_chains as chain_cases

CASES = {
    "ancestral_dps_ddpm": ("dps", "ddpm", {}),
    "uncond_vesde": ("uncond", "vesde", {}),
    "uncond_ddpm": ("uncond", "ddpm", {}),
}


def chains(gt, obs, fbp, **arrays):
    return chain_cases.chains(CASES, gt, obs, fbp, arrays)


if __name__ == "__main__":
    chain_cases.child.main(globals())


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return chain_cases.jax_half(__file__, CASES, tmp_path_factory.mktemp("uncond"), seed=61)


@pytest.mark.parametrize("case", list(CASES))
def test_chain_matches_jax(pair, case):
    chain_cases.check_chain(pair, case)


def test_psnr_trace_matches_jax(pair):
    chain_cases.check_trace(pair, "ancestral_dps_ddpm")
