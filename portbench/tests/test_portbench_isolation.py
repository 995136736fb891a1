"""Nothing of JAX or the JAX package: the check compares whole top-level
names, the reference imports nothing of the program, and a run refuses a
machine without a CUDA card."""

import json
import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def test_whole_names():
    assert harness.banned_modules(["dcnet_tpu_torch", "dcnet_tpu_torch.models", "jaxtyping",
                                   "flaxen", "torch"]) == []
    assert harness.banned_modules(["dcnet_tpu.models", "jax.numpy", "flax", "optax",
                                   "orbax.checkpoint", "jaxlib"]) == [
        "dcnet_tpu", "flax", "jax", "jaxlib", "optax", "orbax"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; "
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    mods = _loaded("import portbench.reference.tasks, portbench.compare, portbench.work.dcnet, "
                   "portbench.weights, portbench.inputs")
    assert "dcnet_tpu_torch" not in mods
    assert not harness.banned_modules(mods)


def test_a_mini_run_loads_no_jax():
    mods = _loaded("import torch; torch.set_num_threads(2)\n"
                   "from portbench.tests import mini\n"
                   "r = mini.run('serve-bilstm-120s-bf16', seconds=0.1)\n"
                   "assert r['correct']")
    assert "dcnet_tpu_torch" in mods
    assert not harness.banned_modules(mods)


def test_run_refuses_a_machine_without_a_card():
    import torch
    if torch.cuda.is_available():
        return          # this test is about the CPU machine
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "serve-bilstm-120s-bf16", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "eval-bert-64clip-bf16", "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and '"correct"' not in p.stdout
