"""The port stands alone: irp_tpu_torch and chip_smoke.py import neither
jax (nor its libraries) nor anything of the JAX package irp_tpu."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "irp_tpu")


def _port_files():
    root = os.path.join(REPO, "irp_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def _modules():
    out = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        out.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                   else rel)
    return out


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{os.path.relpath(path, REPO)}:"
                                     f"{node.lineno} imports {name}")
    assert not offenders, offenders


def test_importing_every_module_leaves_jax_out():
    modules = _modules()
    assert {"irp_tpu_torch.infer", "chip_smoke",
            "irp_tpu_torch.data.outliers", "irp_tpu_torch.data.curation",
            "irp_tpu_torch.data.tar", "irp_tpu_torch.utils.viz",
            "irp_tpu_torch.cli.curation_cli",
            "irp_tpu_torch.tools.bench_fused_block"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('isolated', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout
