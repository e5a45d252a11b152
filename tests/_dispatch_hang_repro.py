"""Reproduce the stall of tier-1's `tests/test_conv3x3.py::test_unet_dispatch_equivalence`.

That JAX test applies a bf16 UNet eagerly with the Pallas conv kernel in
interpret mode.  Pallas interpret mode runs the kernel's host callbacks
(`io_callback`) on one of XLA's CPU threads, and those callbacks dispatch
`jnp` ops themselves while the main thread goes on dispatching the UNet's
ops.  With the CPU client's asynchronous dispatch, and the machine loaded,
the two can wait on each other forever: the stacks of a stalled pytest
worker show the main thread in `jnp` dispatch inside `_group_norm32` and a
callback thread in `jnp` dispatch inside `update_clocks_for_device_barrier`.

This script starts N copies of the test at once, each in its own
interpreter with a time limit, and prints how many finished:

    python tests/_dispatch_hang_repro.py --copies 8 [--sync] [--torch]

`--sync` sets `jax_cpu_enable_async_dispatch` to False before the CPU
backend starts; `--torch` imports torch first (every pytest worker of the
suite has it: collecting tests/test_golden_predictor_steps.py imports it).
It is not collected by pytest (its name starts with an underscore).
"""
import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = """
import os, sys, time
sys.path[:0] = [{tests!r}, {repo!r}]
if {torch}:
    import torch  # noqa: F401
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
import jax
jax.config.update("jax_platforms", "cpu")
if {sync}:
    jax.config.update("jax_cpu_enable_async_dispatch", False)
import test_conv3x3
t0 = time.time()
test_conv3x3.test_unet_dispatch_equivalence()
print(f"finished in {{time.time() - t0:.1f}} s")
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copies", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds a copy may take")
    ap.add_argument("--sync", action="store_true", help="synchronous CPU dispatch")
    ap.add_argument("--torch", action="store_true", help="import torch first")
    args = ap.parse_args()
    code = CHILD.format(tests=HERE, repo=os.path.dirname(HERE), torch=args.torch, sync=args.sync)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True) for _ in range(args.copies)]
    finished = 0
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(args.timeout - (time.time() - t0), 1.0))
            finished += p.returncode == 0
            print(out.strip() or f"failed, rc {p.returncode}")
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            print(f"stalled: killed after {args.timeout:.0f} s")
    print(f"{finished} of {args.copies} copies finished (sync={args.sync}, torch={args.torch})")


if __name__ == "__main__":
    main()
