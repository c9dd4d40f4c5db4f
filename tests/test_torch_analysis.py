"""repro_torch.analysis: the reference's analyzer tests on torch fixtures
(per-rule positive/negative cases, baseline round-trip, JSON schema, the
CLI failing on a bad tree), the port's tree clean modulo its own baseline,
and the reference's CLI and the port's printing the same findings for the
rules the port keeps as they are."""
import json
import os
import subprocess
import sys
import textwrap

from repro_torch.analysis import analyze_paths
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
BASELINE = ".analysis-baseline-torch.json"


def run_rules(tmp_path, source, name="mod.py", rules=None):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return analyze_paths([name], str(tmp_path), rules or ALL_RULES)


def rule_ids(findings):
    return [f.rule for f in findings]


# ======================================================================
# RPR001: a static input of a CUDA-graph capture rebound, then replayed
# ======================================================================

def test_rpr001_positive_static_input_rebound_before_replay(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        def go(model, x_new):
            g = torch.cuda.CUDAGraph()
            static_x = torch.zeros(8)
            with torch.cuda.graph(g):
                out = model(static_x)
            static_x = x_new
            g.replay()
            return out
    """)
    assert rule_ids(fs) == ["RPR001"]
    assert "'static_x'" in fs[0].message and "copy_" in fs[0].message


def test_rpr001_positive_attribute_buffer_rebound(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        class Plane:
            def run(self, toks):
                with torch.cuda.graph(self.graph):
                    out = self.model(self.static_toks)
                self.static_toks = toks
                self.graph.replay()
                return out
    """)
    assert rule_ids(fs) == ["RPR001"]
    assert "'self.static_toks'" in fs[0].message


def test_rpr001_negative_copy_refills_static_input(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        def go(model, g, static_x, x_new):
            with torch.cuda.graph(g):
                out = model(static_x)
            static_x.copy_(x_new)
            g.replay()
            return out
    """)
    assert fs == []


def test_rpr001_negative_captured_output_and_no_later_replay(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        def go(model, g, static_x, x_new):
            with torch.cuda.graph(g):
                out = model(static_x)
            g.replay()
            out = out.clone()          # assigned inside the capture
            static_x = x_new           # rebound, but never replayed after
            return out, static_x
    """)
    assert fs == []


def test_rpr001_rebind_in_replay_loop(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        def serve(g, static_x, batches, model):
            with torch.cuda.graph(g):
                y = model(static_x)
            for b in batches:
                static_x = b
                g.replay()
            return y
    """)
    assert rule_ids(fs) == ["RPR001"]


# ======================================================================
# RPR002 refcount-balance (kept as the reference has it)
# ======================================================================

def test_rpr002_positive_alloc_without_exception_path(tmp_path):
    fs = run_rules(tmp_path, """
        class Worker:
            def grab(self, n):
                blocks = self.pool.alloc(n)
                self.compute(blocks)
                return blocks
    """)
    assert rule_ids(fs) == ["RPR002"]
    assert "pool.alloc" in fs[0].message


def test_rpr002_negative_release_in_handler(tmp_path):
    fs = run_rules(tmp_path, """
        class Worker:
            def grab(self, n):
                blocks = self.pool.alloc(n)
                try:
                    self.compute(blocks)
                except BaseException:
                    self.pool.drop(blocks)
                    raise
                return blocks
    """)
    assert fs == []


def test_rpr002_negative_no_risky_work_after_acquire(tmp_path):
    fs = run_rules(tmp_path, """
        class Worker:
            def grab(self, n, out):
                blocks = self.pool.alloc(n)
                out.extend(blocks)
                return blocks
    """)
    assert fs == []


def test_rpr002_skips_test_files(tmp_path):
    src = """
        def test_pool(pool):
            blocks = pool.alloc(4)
            pool.do_something_risky(blocks)
    """
    assert run_rules(tmp_path, src, name="mod.py") != []
    assert run_rules(tmp_path, src, name="test_mod.py") == []


# ======================================================================
# RPR003 host-sync-in-hot-path
# ======================================================================

def test_rpr003_positive_all_sync_kinds(tmp_path):
    fs = run_rules(tmp_path, """
        import numpy as np
        import torch

        class ToyScheduler:
            def step(self, x, arr, d, t):
                torch.cuda.synchronize()
                v = float(arr[0])
                y = np.asarray(d)
                a = x.item()
                b = t.tolist()
                c = t.cpu()
                n = t.numpy()
                return v, y, a, b, c, n
    """)
    assert rule_ids(fs) == ["RPR003"] * 7


def test_rpr003_negative_cold_function_and_cold_class(tmp_path):
    fs = run_rules(tmp_path, """
        import numpy as np
        import torch

        class ToyScheduler:
            def shutdown(self, x):
                torch.cuda.synchronize()       # not a hot function name
                return x.cpu()

        class Summary:
            def step(self, d):
                return d.tolist()              # not a hot class / path
    """)
    assert fs == []


def test_rpr003_next_tokens_readback_in_serving(tmp_path):
    """The decode plane's token read-back is in scope (and baselined in
    the repo): ``.cpu().tolist()`` in ``next_tokens`` is found, once (one
    copy: the chain's ``.cpu()``)."""
    fs = run_rules(tmp_path, """
        def next_tokens(logits, seqs, device):
            return logits.argmax(-1).cpu().tolist()
    """, name="serving/decode.py")
    assert rule_ids(fs) == ["RPR003"]
    assert fs[0].message.split()[0] == ".cpu()"


# ======================================================================
# RPR004 unbucketed-shape-into-jit
# ======================================================================

def test_rpr004_positive_runtime_len_reaches_step_shape(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        class Plane:
            def run(self, seqs):
                npages = max(len(s.bt) for s in seqs)
                bt = torch.zeros((4, npages), dtype=torch.int32)
                return self._step(bt)
    """)
    assert "RPR004" in rule_ids(fs)
    assert any("'npages'" in f.message for f in fs)


def test_rpr004_negative_bucketed(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        class Plane:
            def run(self, seqs):
                npages = next_pow2(max(len(s.bt) for s in seqs))
                bt = torch.zeros((4, npages), dtype=torch.int32)
                return self._step(toks)
    """)
    assert fs == []


def test_rpr004_negative_len_over_self_attr_is_static(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        class Plane:
            def run(self, toks):
                m = len(self.model_ids)
                lanes = torch.zeros((4, m), dtype=torch.int32)
                return self._step(lanes)
    """)
    assert fs == []


def test_rpr004_step_body_and_compiled_entry(tmp_path):
    """A ``step`` body is itself an entry (a capture keys on its shapes),
    a runtime ``max`` is a length, and a ``torch.compile`` result is an
    entry like a ``step``."""
    fs = run_rules(tmp_path, """
        import numpy as np
        import torch

        class StackedDecoders:
            def step(self, seqs, counts):
                bmax = max(counts)
                return np.zeros((len(self.ids), bmax), np.int32)

        fwd = torch.compile(forward)

        def prefill(toks):
            n = toks.shape[1]
            return fwd(torch.empty(n))
    """)
    assert rule_ids(fs) == ["RPR004", "RPR004"]
    assert "'bmax'" in fs[0].message and "'n'" in fs[1].message


# ======================================================================
# RPR005 side-effect-in-jit
# ======================================================================

def test_rpr005_positive_self_mutation_and_print(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        def _impl(self, x):
            self.count += 1
            print(x)
            return x

        stepper = torch.compile(_impl)
    """)
    assert rule_ids(fs) == ["RPR005", "RPR005"]
    assert "self.count" in fs[0].message


def test_rpr005_positive_decorated_and_nested(tmp_path):
    fs = run_rules(tmp_path, """
        import time
        import torch

        @torch.compile(mode="reduce-overhead")
        def outer(x):
            def inner(y):
                t = time.perf_counter()
                return y
            return inner(x)
    """)
    assert rule_ids(fs) == ["RPR005"]
    assert "time.perf_counter" in fs[0].message


def test_rpr005_negative_uncompiled_and_pure(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        def bookkeeping(self, x):
            self.count += 1          # not traced: fine
            return x

        def _pure(x):
            return x + 1

        stepper = torch.compile(_pure)
    """)
    assert fs == []


def test_rpr005_positive_inside_graph_capture(tmp_path):
    fs = run_rules(tmp_path, """
        import time
        import torch

        class Plane:
            def capture(self, x):
                with torch.cuda.graph(self.graph):
                    self.steps += 1
                    t0 = time.perf_counter()
                    self.out = self.model(x)
                return self.out
    """)
    assert rule_ids(fs) == ["RPR005"] * 3
    assert "CUDA-graph capture" in fs[0].message


# ======================================================================
# RPR006 metrics-instrument-in-step (kept as the reference has it)
# ======================================================================

def test_rpr006_positive_instrument_in_step(tmp_path):
    fs = run_rules(tmp_path, """
        class Engine:
            def step(self):
                c = self.registry.counter("tokens", "help")
                c.inc()
    """)
    assert rule_ids(fs) == ["RPR006"]
    assert "hoisted" in fs[0].message


def test_rpr006_negative_instrument_in_init(tmp_path):
    fs = run_rules(tmp_path, """
        class Engine:
            def __init__(self, reg):
                self._c = reg.counter("tokens", "help")

            def step(self):
                self._c.inc()
    """)
    assert fs == []


# ======================================================================
# RPR007 host-materialized-pool-pages
# ======================================================================

def test_rpr007_positive_cpu_copy_of_pool_pages(tmp_path):
    fs = run_rules(tmp_path, """
        def snapshot(kvpool):
            return kvpool.k_groups["pos0"].cpu()
    """)
    assert rule_ids(fs) == ["RPR007"]
    assert "swap tier" in fs[0].message


def test_rpr007_positive_every_host_copy_kind(tmp_path):
    fs = run_rules(tmp_path, """
        import numpy as np
        import torch

        def dump(kvpool, pool):
            a = kvpool.pool_state()["kt"][0].to("cpu")
            b = pool.v_tail[0].to(device=torch.device("cpu"))
            c = np.asarray(pool.k_tail[0])
            d = pool.v_groups["pos0"].numpy()
            e = kvpool.k_tail[0].tolist()
            return a, b, c, d, e
    """)
    assert rule_ids(fs) == ["RPR007"] * 5


def test_rpr007_negative_sanctioned_swap_module(tmp_path):
    fs = run_rules(tmp_path, """
        def put(kvpool, rows):
            return kvpool.k_groups["pos0"].index_select(1, rows).cpu()
    """, name="kvcache/swap.py")
    assert fs == []


def test_rpr007_negative_non_pool_host_copies(tmp_path):
    fs = run_rules(tmp_path, """
        import torch

        def tokens_of(seq, logits):
            return seq.out.cpu(), logits.to("cpu"), logits.to(torch.float32)
    """)
    assert fs == []


# ======================================================================
# framework: fingerprints, baseline round-trip, JSON schema, CLI
# ======================================================================

BAD_SOURCE = """
class Worker:
    def grab(self, n):
        blocks = self.pool.alloc(n)
        self.compute(blocks)
        return blocks
"""


def test_every_rule_has_id_and_registry_entry():
    ids = [r.rule_id for r in ALL_RULES]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    assert set(RULES_BY_ID) == {f"RPR00{i}" for i in range(1, 8)}


def test_fingerprints_stable_across_line_shifts(tmp_path):
    f1 = run_rules(tmp_path, BAD_SOURCE)
    f2 = run_rules(tmp_path, "# a comment\n\n\n" + BAD_SOURCE)
    assert [f.fingerprint for f in f1] == [f.fingerprint for f in f2]
    assert f1[0].line != f2[0].line


def test_syntax_error_files_are_skipped(tmp_path):
    (tmp_path / "broken.py").write_text("def nope(:\n")
    assert analyze_paths(["broken.py"], str(tmp_path), ALL_RULES) == []


def test_cli_baseline_round_trip(tmp_path, capsys):
    (tmp_path / "mod.py").write_text(BAD_SOURCE)
    root = str(tmp_path)
    # dirty tree -> exit 1
    assert cli_main(["mod.py", "--root", root]) == 1
    # accept into baseline -> exit 0
    assert cli_main(["mod.py", "--root", root, "--update-baseline"]) == 0
    assert cli_main(["mod.py", "--root", root]) == 0
    bl = json.loads((tmp_path / BASELINE).read_text())
    assert bl["version"] == 1 and len(bl["entries"]) == 1
    assert bl["entries"][0]["rule"] == "RPR002"
    # inject a NEW violation -> exit 1 again, old one stays baselined
    (tmp_path / "mod2.py").write_text(BAD_SOURCE)
    capsys.readouterr()
    assert cli_main(["mod.py", "mod2.py", "--root", root]) == 1
    out = capsys.readouterr().out
    assert "mod2.py" in out and "mod.py:" not in out


def test_cli_stale_baseline_warns_but_passes(tmp_path, capsys):
    (tmp_path / "mod.py").write_text(BAD_SOURCE)
    root = str(tmp_path)
    assert cli_main(["mod.py", "--root", root, "--update-baseline"]) == 0
    (tmp_path / "mod.py").write_text("x = 1\n")       # finding gone
    capsys.readouterr()
    assert cli_main(["mod.py", "--root", root]) == 0
    assert "stale baseline entry" in capsys.readouterr().err


def test_cli_json_schema(tmp_path, capsys):
    (tmp_path / "mod.py").write_text(BAD_SOURCE)
    cli_main(["mod.py", "--root", str(tmp_path), "--json", "-"])
    out = capsys.readouterr().out
    payload = json.loads(out[:out.rindex("}") + 1])
    assert payload["version"] == 1
    (f,) = payload["findings"]
    assert {"rule", "path", "line", "col", "message", "func", "line_text",
            "fingerprint", "baselined"} <= set(f)
    assert f["rule"] == "RPR002" and f["func"] == "Worker.grab"
    assert payload["summary"]["new"] == 1
    assert payload["summary"]["by_rule"] == {"RPR002": 1}


def test_cli_unknown_rule_and_missing_path(tmp_path):
    assert cli_main(["--root", str(tmp_path), "--rules", "RPR999"]) == 2
    assert cli_main(["nope_dir", "--root", str(tmp_path)]) == 2


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=120)


def test_cli_subprocess_fails_on_bad_tree(tmp_path):
    """The CI-job contract end to end: module invocation, exit 1 on a tree
    with a violation, exit 0 once baselined."""
    (tmp_path / "bad.py").write_text(BAD_SOURCE)
    args = ["bad.py", "--root", str(tmp_path)]
    r = _cli("repro_torch.analysis", *args)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "RPR002" in r.stdout
    r = _cli("repro_torch.analysis", *args, "--update-baseline")
    assert r.returncode == 0, r.stdout + r.stderr
    r = _cli("repro_torch.analysis", *args)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_is_clean_modulo_its_baseline():
    """The port's acceptance criterion as a test: the port's analyzer over
    the port, the tests and chip_smoke.py reports nothing beyond
    .analysis-baseline-torch.json, and every baseline entry is justified."""
    r = _cli("repro_torch.analysis", "src/repro_torch", "tests",
             "chip_smoke.py", "--root", ROOT, "--baseline", BASELINE)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "stale" not in r.stderr, r.stderr
    with open(os.path.join(ROOT, BASELINE)) as f:
        entries = json.load(f)["entries"]
    assert entries and all(e["note"] and not e["note"].startswith("TODO")
                           for e in entries)


def test_reference_and_port_print_the_same_findings(tmp_path):
    """On a fixture that trips the two rules the port keeps as they are
    (RPR002, RPR006), the reference's CLI and the port's print the same
    JSON findings, fingerprints included."""
    (tmp_path / "mod.py").write_text(BAD_SOURCE + textwrap.dedent("""
        class Engine:
            def step(self):
                self.registry.gauge("depth", "help").set(1)
    """))
    got = {}
    for module in ("repro.analysis", "repro_torch.analysis"):
        r = _cli(module, "mod.py", "--root", str(tmp_path), "--rules",
                 "RPR002,RPR006", "--json", "-")
        assert r.returncode == 1, r.stdout + r.stderr
        out = r.stdout
        got[module] = json.loads(out[:out.rindex("}") + 1])["findings"]
    assert got["repro.analysis"] == got["repro_torch.analysis"]
    assert [f["rule"] for f in got["repro_torch.analysis"]] == ["RPR002",
                                                                 "RPR006"]
