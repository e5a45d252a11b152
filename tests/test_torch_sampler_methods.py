"""The port's conditional score-SDE chains against the JAX engine.

Naive and DPS on VESDE, and DPS started from the FBP with the Langevin
corrector after each step: whole chains of `N_STEPS` steps through
`factory.get_standard_sampler` on both sides, and the per-step PSNR trace
that each returns.  How the two sides are fed and compared, and the
tolerances, are in tests/_torch_chains.py; the unconditional and the DDPM
chains are in tests/test_torch_sampler_uncond.py.

The torch half runs in one child interpreter for all cases
(tests/_torch_child.py): no pytest process runs torch code.
"""
import pytest

import _torch_chains as chain_cases

CASES = {
    "naive_vesde": ("naive", "vesde", {}),
    "dps_vesde": ("dps", "vesde", {}),
    # one chain for both: the JAX engine compiles each case anew, which
    # takes most of this file's time
    "dps_fbp_start_corrector_vesde": ("dps", "vesde", {"pct_chain_elapsed": 0.5,
                                                       "add_corrector_step": True}),
}


def chains(gt, obs, fbp, **arrays):
    return chain_cases.chains(CASES, gt, obs, fbp, arrays)


if __name__ == "__main__":
    chain_cases.child.main(globals())


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return chain_cases.jax_half(__file__, CASES, tmp_path_factory.mktemp("methods"), seed=41)


@pytest.mark.parametrize("case", list(CASES))
def test_chain_matches_jax(pair, case):
    chain_cases.check_chain(pair, case)


@pytest.mark.parametrize("case", list(CASES))
def test_psnr_trace_matches_jax(pair, case):
    chain_cases.check_trace(pair, case)
