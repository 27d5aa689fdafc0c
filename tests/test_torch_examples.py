"""The port's examples (``examples/*_torch.py``) run end to end on the CPU
with ``--device cpu`` at small arguments, each in a subprocess where any
``import jax`` raises, and load nothing of JAX or of the reference
package. Each is held to its own assertions (the quickstart's
``final_acc > 0.5``, the training driver's falling loss) and to the lines
it prints."""
import os
import subprocess
import sys

import pytest

import torch

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")

_RUN = """
import runpy, sys
sys.modules["jax"] = None            # any `import jax` now raises
path, argv = sys.argv[1], sys.argv[2:]
sys.argv = [path] + argv
runpy.run_path(path, run_name="__main__")
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith(("repro.", "jax"))))
print("LEAKED", leaked)
"""

# (example, arguments, a line its output must hold); the shortest runs
# that still clear each example's own assertion
CASES = {
    "quickstart": (["--steps", "100"], "quickstart OK"),
    "classical_fl": (["--steps", "40"], "U-DGD(SURF, star) @ 8 rounds"),
    "decentralized_fl": (["--steps", "40", "--scenario", "link-failure"],
                         "U-DGD(link-failure) @ 16 rounds"),
    "serve_federations": ([], "solved in one forward pass"),
    "serve_arch": ([], "sample ids"),
    "train_lm": (["--arch", "qwen3-4b", "--steps", "12", "--batch", "4",
                  "--seq", "32", "--lr", "3e-3", "--log-every", "4"],
                 "done: loss"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu_without_jax(name, tmp_path):
    argv, marker = CASES[name]
    if name == "train_lm":
        argv = argv + ["--ckpt", str(tmp_path / "ckpt")]
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    # one thread: the suite runs several workers at once, and these small
    # ops gain nothing from more
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _RUN, path, *argv,
                          "--device", "cpu"], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert marker in out.stdout, out.stdout[-3000:]
    assert "LEAKED []" in out.stdout
    if name == "serve_arch":
        assert "prefill 2x12" in out.stdout      # the reference's defaults
    if name == "train_lm":
        assert any(p.name.startswith("ckpt") for p in tmp_path.iterdir())
