"""Run the torch half of a port test in a child interpreter.

No pytest process runs torch code.  The suite's xdist workers run the JAX
package's tests, and torch's thread pools and state would otherwise live
on in a worker for every file it is given later.  So each
`tests/test_torch_*.py` keeps its JAX half in the pytest process and hands
its torch half to `run`, which starts

    python tests/test_torch_<name>.py <case> <in.npz> <out.npz>

with a timeout of its own: a stall then fails one test and no longer cuts
the suite.  The file's `if __name__ == "__main__":` block calls `main`,
which runs the function named `<case>` on the arrays of `in.npz` and
writes what it returns to `out.npz`.  A failed assertion in the child fails
the test with the child's stderr.  Nested parameter trees cross as flat
"a/b/c" keys (`flatten`, `unflatten`).  This module imports numpy only.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120    # seconds a child may take unless its case states more
# CPU threads of a child (OMP_NUM_THREADS): the suite runs several xdist
# workers at once, and torch's default of one thread per core in each of
# their children oversubscribes the cores
THREADS = 2


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": array} from a nested dict of arrays (a flax parameter tree)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: dict, prefix: str = "") -> dict:
    """The nested dict of the keys of `flat` that start with `prefix`."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *mods, name = key[len(prefix):].split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = v
    return out


class Pending:
    """A child started by `start`; `result()` waits for it."""

    def __init__(self, test_file, case, tmp_path, timeout, inputs):
        self.case, self.timeout = case, timeout
        inp, self.out = tmp_path / f"{case}_in.npz", tmp_path / f"{case}_out.npz"
        np.savez(inp, **inputs)
        # output to a file, not a pipe: a full pipe would stall the child
        self.log = tmp_path / f"{case}_log.txt"
        env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen([sys.executable, test_file, case, str(inp), str(self.out)],
                                         stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env)

    def result(self) -> dict:
        try:
            self.proc.wait(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise
        assert self.proc.returncode == 0, (f"{self.case} failed in its child "
                                           f"(rc {self.proc.returncode}):\n"
                                           f"{self.log.read_text()[-8000:]}")
        with np.load(self.out) as f:
            return {k: f[k] for k in f.files}


def start(test_file: str, case: str, tmp_path, timeout: float = TIMEOUT, **inputs) -> Pending:
    """Start `case` of `test_file` in a child interpreter on `inputs` (arrays,
    numbers or strings), so that the test's JAX half can run meanwhile; the
    timeout counts from `result()`."""
    return Pending(test_file, case, tmp_path, timeout, inputs)


def run(test_file: str, case: str, tmp_path, timeout: float = TIMEOUT, **inputs) -> dict:
    """Run `case` of `test_file` in a child interpreter on `inputs` and return
    the arrays it wrote, by name."""
    return start(test_file, case, tmp_path, timeout, **inputs).result()


def main(namespace: dict) -> None:
    """The child's side of `run`: call `namespace[<case>]` on the input arrays."""
    case, inp, out = sys.argv[1:4]
    sys.path.insert(0, REPO)
    with np.load(inp) as f:
        inputs = {k: f[k] for k in f.files}
    result = namespace[case](**inputs) or {}
    np.savez(out, **result)
    sys.exit(0)
