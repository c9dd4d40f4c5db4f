"""Import hygiene of the port: no JAX and nothing of the reference package.

``src/repro_torch`` and ``chip_smoke.py`` run on a machine that has no JAX;
every module must import with ``jax`` blocked, and no file may name ``jax``
or ``repro`` in an import. Each port package exports every name its
reference package exports, but for ``NOT_EXPORTED``.
"""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None           # any `import jax` now raises
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
print(" ".join(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    visited = set(r.stdout.split())
    assert len(visited) >= 20                   # every module was visited
    assert {"repro_torch.kernels.flash_prefill_paged",
            "repro_torch.serving.scheduler.queue",
            "repro_torch.serving.scheduler.scheduler",
            "repro_torch.serving.sampling",
            "repro_torch.serving.metrics",
            "repro_torch.core.lora",
            "repro_torch.kvcache.swap",
            "repro_torch.kvcache.sanitize",
            "repro_torch.serving.preempt",
            "repro_torch.serving.costmodel",
            "repro_torch.serving.autoscale",
            "repro_torch.models.moe",
            "repro_torch.models.ssd",
            "repro_torch.models.rglru",
            "repro_torch.kvcache.handoff",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.mamba2_780m",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.configs.seamless_m4t_medium",
            "repro_torch.configs.internvl2_76b",
            "repro_torch.configs.gemma2_27b",
            "repro_torch.configs.grok_1_314b",
            "repro_torch.configs.chatglm3_6b",
            "repro_torch.configs.granite_8b",
            "repro_torch.configs.internlm2_1_8b",
            "repro_torch.configs.qwen3",
            "repro_torch.training",
            "repro_torch.training.data",
            "repro_torch.training.optim",
            "repro_torch.training.checkpoint",
            "repro_torch.training.trainer",
            "repro_torch.launch.train",
            "repro_torch.serving.simulator",
            "repro_torch.serving.workload",
            "repro_torch.serving.backpressure",
            "repro_torch.launch.serve",
            "repro_torch.launch.analytic",
            "repro_torch.analysis",
            "repro_torch.analysis.__main__",
            "repro_torch.analysis.baseline",
            "repro_torch.analysis.cli",
            "repro_torch.analysis.core",
            "repro_torch.analysis.rules",
            "repro_torch.launch.steps",
            "repro_torch.launch.mesh",
            "repro_torch.launch.sharding",
            "repro_torch.launch.commanalysis",
            "repro_torch.launch.dryrun"} <= visited


#: names a reference package exports that its port does not, with the
#: reason: the pool is updated in place, so the sanitizer's donation-
#: poisoning pool wrapper has nothing to wrap; ``steps`` imports
#: ``apply_updates`` for its train step, which the port's reaches through
#: ``Trainer.step``; ``NamedSharding`` and ``P`` are jax's sharding types
#: (the port's specs are tuples of axis names, its placements DTensor
#: ``Placement``s); ``analyze`` parses HLO text, which torch does not have
NOT_EXPORTED = {"repro.kvcache": {"SanitizedKVPool"},
                "repro.launch.steps": {"apply_updates"},
                "repro.launch.sharding": {"NamedSharding", "P"},
                "repro.launch.hloanalysis": {"analyze"}}
#: the reference's packages with an ``__init__`` of exports, and its launch
#: modules of the sharded tools; each is held against the port's module of
#: the same name, but for ``COUNTERPART``
PACKAGES = ["configs", "core", "kernels", "kvcache", "models", "serving",
            "serving.scheduler", "training", "analysis", "launch.steps",
            "launch.mesh", "launch.sharding", "launch.dryrun",
            "launch.hloanalysis"]
#: torch has no HLO: ``launch.commanalysis`` records the collectives a step
#: issues as it runs (a ``TorchDispatchMode``) where ``launch.hloanalysis``
#: parses them out of compiled HLO text; both return ``collective_bytes``'
#: ``{"by_op", "counts", "total", "loops"}`` with the same byte semantics
COUNTERPART = {"launch.hloanalysis": "launch.commanalysis"}


def _exports(module) -> set:
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n, v in vars(module).items()
                 if not n.startswith("_") and not isinstance(v, ModuleType)]
    return set(names)


def _reference(pkg):
    """The reference module. Importing ``repro.launch.dryrun`` sets
    ``XLA_FLAGS`` to 512 host devices, which must not reach the jax tests
    this worker runs later: the variable is put back."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.{pkg}")
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


@pytest.mark.parametrize("pkg", PACKAGES)
def test_port_exports_what_the_reference_exports(pkg):
    ref = _reference(pkg)
    port = importlib.import_module(
        f"repro_torch.{COUNTERPART.get(pkg, pkg)}")
    missing = _exports(ref) - set(vars(port)) \
        - NOT_EXPORTED.get(f"repro.{pkg}", set())
    assert not missing, f"repro_torch.{pkg} lacks {sorted(missing)}"
