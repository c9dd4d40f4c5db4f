"""The import guard: with ``jax``, ``jaxlib``, ``flax`` and the JAX package
``repro`` blocked (top-level names compared whole: the port's
``repro_torch`` begins with ``repro`` and is not it), the command, the
harness, every metric reader and the reference import; the reference
imports nothing of the port; and the command's own check tells the two
names apart."""
from __future__ import annotations

import subprocess
import sys
import textwrap

import servebench_tiny as tiny

BLOCK = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {"jax", "jaxlib", "flax", "repro"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path[:0] = [%r, %r]
""") % (str(tiny.REPO / "servebench"), str(tiny.REPO / "src"))


def _run(body: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", BLOCK + textwrap.dedent(body)],
                          capture_output=True, text=True, timeout=300,
                          cwd=tiny.REPO)


def test_harness_metrics_and_reference_import_with_jax_blocked():
    out = _run(f"""
        from pathlib import Path
        import run
        from benchlib import (check, cost, devtrace, harness, loop, spec,
                              stats, tails, traffic, weights)
        root = Path({str(tiny.REPO)!r})
        for f in sorted((root / "servebench/metrics").glob("*.py")):
            spec.metric_reader(root, f.stem)
        spec.load_module(root / "servebench/reference/decoder_lm.py", "ref")
        import repro_torch.serving, repro_torch.core.lora
        assert run.forbidden_modules() == [], run.forbidden_modules()
        print("ok", len(sys.modules))
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_reference_imports_nothing_of_the_port():
    out = _run("""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "ref", %r)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("repro_torch", "benchlib"))
        assert not bad, bad
        print("ok")
    """ % str(tiny.REPO / "servebench/reference/decoder_lm.py"))
    assert out.returncode == 0, out.stderr


def test_the_commands_check_compares_whole_names():
    out = _run("""
        import types
        import run
        sys.modules["repro_torch_probe"] = types.ModuleType("x")
        assert run.forbidden_modules() == []
        sys.modules["repro.serving"] = types.ModuleType("x")
        assert run.forbidden_modules() == ["repro"]
        print("ok")
    """)
    assert out.returncode == 0, out.stderr


def test_the_command_refuses_without_a_card(tmp_path):
    """No card: a code other than 0 and no result line."""
    out = subprocess.run(
        [sys.executable, str(tiny.REPO / "servebench/run.py"), "--workload",
         tiny.CELLS[0], "--seed", str(2**31 + 11), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tiny.REPO, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
