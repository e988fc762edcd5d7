"""The port's public names against the JAX package's, module by module.

For every module of ``deepgraphpose_tpu/`` that has a counterpart at the
same path under ``deepgraphpose_tpu_torch/``, every top-level public name
that a user of the JAX module can import from it must be importable from
the port's module too. The JAX module's names are the ones it defines
(functions, classes, assignments) and the ones it imports from its own
package (a re-export such as ``train/fit.py``'s ``DGPLossParams``);
names it imports from elsewhere (jax, numpy, click, ...) are not the
package's. The port's names are every top-level binding. Both files are
parsed with ``ast``, so neither package is imported.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "deepgraphpose_tpu", "deepgraphpose_tpu_torch"

# names of a JAX module that are JAX or click objects, with no counterpart
# in a package that imports neither
ALLOWED = {
    # the click context settings of the JAX package's click CLI; the
    # port's CLI is argparse
    ("cli.py", "CTX"),
    # jax.sharding constructors (NamedSharding over a Mesh); the port's
    # data group replicates and reduces with torch.distributed
    ("parallel/mesh.py", "data_sharding"),
    ("parallel/mesh.py", "replicated"),
    # XLA's persistent compilation cache directory; the port's cache of
    # built kernels is DEFAULT_BUILD_ROOT
    ("utils/compile_cache.py", "DEFAULT_CACHE_DIR"),
}

# JAX modules with no module at the same path in the port: the Pallas
# decode kernel, which the port has as csrc/softargmax.cu
NO_COUNTERPART = {"ops/pallas/__init__.py", "ops/pallas/softargmax_kernel.py"}


def _bound(node) -> list:
    """The names a top-level statement binds: (name, imported from)."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [(node.name, None)]
    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [
            node.target]
        return [(n.id, None) for t in targets for n in ast.walk(t)
                if isinstance(n, ast.Name)]
    if isinstance(node, ast.Import):
        return [((a.asname or a.name).split(".")[0],
                 a.name if a.asname else a.name.split(".")[0])
                for a in node.names]
    if isinstance(node, ast.ImportFrom):
        source = "." * node.level + (node.module or "")
        return [(a.asname or a.name, source) for a in node.names]
    out = []                    # if / try / with blocks at the top level
    for field in ("body", "orelse", "finalbody", "handlers"):
        for child in getattr(node, field, []) or []:
            out.extend(_bound(child))
    return out


def public_names(path: Path, package: str | None) -> set:
    """Top-level public names of a module. With ``package``, a name that
    the module imports counts only when it comes from that package."""
    names, foreign = set(), set()
    for node in ast.parse(path.read_text()).body:
        for name, source in _bound(node):
            if name.startswith("_"):
                continue
            if (package is None or source is None or source.startswith(".")
                    or source.split(".")[0] == package):
                names.add(name)
            else:
                foreign.add(name)
    # an optional import's fallback (``except ImportError: cv2 = None``)
    # rebinds the foreign name
    return names - foreign


def module_pairs() -> list:
    return sorted(str(p.relative_to(ROOT / JAX_PKG))
                  for p in (ROOT / JAX_PKG).rglob("*.py"))


def test_every_jax_module_has_a_port_module():
    missing = {rel for rel in module_pairs()
               if not (ROOT / PORT_PKG / rel).exists()}
    assert missing == NO_COUNTERPART


@pytest.mark.parametrize("rel", [r for r in module_pairs()
                                 if r not in NO_COUNTERPART])
def test_port_module_has_the_jax_modules_names(rel):
    want = public_names(ROOT / JAX_PKG / rel, JAX_PKG)
    have = public_names(ROOT / PORT_PKG / rel, None)
    missing = {n for n in want - have if (rel, n) not in ALLOWED}
    assert not missing, f"{PORT_PKG}/{rel} lacks {sorted(missing)}"


def test_allow_list_names_are_still_missing():
    """Each allowed name is one the JAX module has and the port lacks, so
    the list stays as short as the difference."""
    for rel, name in ALLOWED:
        assert name in public_names(ROOT / JAX_PKG / rel, JAX_PKG)
        assert name not in public_names(ROOT / PORT_PKG / rel, None)


# the names the port re-exports so that it has the JAX package's surface,
# and the port module that defines each
REEXPORTS = [
    ("train.fit", "DGPLossParams", "ops.dgp_objective"),
    ("train.fit", "compute_spatial_bounds", "ops.dgp_objective"),
    ("train.fit", "resolve_project", "core.paths"),
    ("train.headonly", "dlc_supervised_loss", "train.steps"),
    ("train.headonly", "init_model", "models.pose_model"),
    ("infer.predict", "init_model", "models.pose_model"),
    ("infer.predict", "softargmax_2d", "ops.softargmax"),
    ("models.pose_model", "make_backbone", "models.resnet"),
    ("parallel.train_dp", "dgp_loss", "ops.dgp_objective"),
    ("parallel.distributed", "DATA_AXIS", "parallel.mesh"),
    ("parallel.streaming", "DATA_AXIS", "parallel.mesh"),
    ("parallel.train_dp", "DATA_AXIS", "parallel.mesh"),
]

MODULE_ALIASES = [
    ("infer.predict", "ckpt_lib", "core.checkpoint"),
    ("models.pose_model", "mobilenet_lib", "models.mobilenet"),
    ("ops.dgp_objective", "softargmax", "ops.softargmax"),
]


@pytest.mark.parametrize("module,name,home", REEXPORTS + MODULE_ALIASES)
def test_reexports_are_the_ports_own_objects(module, name, home):
    got = getattr(importlib.import_module(f"{PORT_PKG}.{module}"), name)
    home_mod = importlib.import_module(f"{PORT_PKG}.{home}")
    want = home_mod if (module, name, home) in MODULE_ALIASES else getattr(
        home_mod, name)
    assert got is want


def test_mpii_snapshot():
    from deepgraphpose_tpu.models.pretrained import MPII_SNAPSHOT as want
    from deepgraphpose_tpu_torch.models.pretrained import MPII_SNAPSHOT
    assert MPII_SNAPSHOT == want == "snapshot-1030000"
