"""No module of JAX or of the JAX package in a run, compared by whole
top-level names; the command's refusals (no card, no program)."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = os.path.dirname(harness.BENCH_DIR)


def test_whole_top_level_names():
    assert harness.forbidden_modules(["irp_tpu_torch", "irp_tpu_torch.serve",
                                      "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["irp_tpu.models", "jax.numpy",
                                      "optax", "flax.linen",
                                      "orbax.checkpoint", "jaxlib"]) == [
        "flax", "irp_tpu", "jax", "jaxlib", "optax", "orbax"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import harness, tracing\n"
        "from benchmark.loops import train, common\n"
        "from benchmark.reference import models, train as rt\n"
        "import irp_tpu_torch.train.step, irp_tpu_torch.train.state\n"
        "import irp_tpu_torch.train.loop, irp_tpu_torch.data.pipeline\n"
        "import irp_tpu_torch.models.classifier\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run(root, *args):
    return subprocess.run(
        [sys.executable, os.path.join(root, "benchmark", "run.py"),
         "--workload", "resnet50.train.b256", "--seed", "3000000000",
         "--seconds", "1", "--trace", "0", *args], cwd=root,
        capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(root / "benchmark" / "run.py"), "--workload",
         "resnet50.train.b256", "--seed", "1", "--seconds", "1"],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
