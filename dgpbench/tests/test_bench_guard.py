"""Nothing the benchmark runs loads JAX or the JAX package, and a run
without a card prints no result."""

import json
import subprocess
import sys
import types

from dgpbench import harness
from dgpbench.run import ROOT

JAX_NAMES = ("jax", "jaxlib", "flax", "deepgraphpose_tpu")


def test_the_reference_imports_nothing_of_jax_or_the_program():
    code = ("import sys, json, pkgutil, importlib\n"
            "import dgpbench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('dgpbench.reference.' + m.name)\n"
            "import dgpbench.reference.families as f\n"
            "for m in pkgutil.iter_modules(f.__path__):\n"
            "    importlib.import_module('dgpbench.reference.families.'"
            " + m.name)\n"
            "import dgpbench.counts.flops, dgpbench.counts.roofline\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in "
            "sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not top & {*JAX_NAMES, "deepgraphpose_tpu_torch"}


def test_blocked_modules_compares_whole_top_level_names(monkeypatch):
    before = set(harness.blocked_modules())
    for name in ("deepgraphpose_tpu_torch_extra", "jaxtyping",
                 "deepgraphpose_tpu_torch.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.blocked_modules()) == before
    for name in ("jax.numpy", "deepgraphpose_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.blocked_modules()) - before == {
        "deepgraphpose_tpu.ops", "jax.numpy"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "dgpbench/run.py", "--workload",
         "resnet50-infer-bf16", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(ROOT / "build")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
