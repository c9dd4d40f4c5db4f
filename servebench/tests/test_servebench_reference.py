"""Whole runs of the harness at a tiny size: the plain reference against the
port's engine through each cell's path, the control and the planted
faults, and a cell, configuration, traffic mix and metric added as new
files only.

On the CPU the card's look is skipped (``harness.run_cell`` on the CPU);
everything else of a run is driven: weights, engine, set-up, window,
drain, the sample, the reference and the verdict. The tiny
configurations run in float32, where the port's path and the reference
agree to rounding, so the limit is 1e-4 logit. The ``gpu`` case runs the
same on the card."""
from __future__ import annotations

import json

import pytest

import servebench_tiny as tiny

CELLS = tiny.CELLS


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_at_a_small_size(root, cell):
    out = tiny.run(root, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_gap"]["value"] <= 1e-4
    assert out["run"]["argmax_match"] == 1.0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["not_served_in_full"] == {"value": 0, "limit": 0}
    e2e = {"req_p95_s", "setup_s"}
    if "unshared" in cell:
        e2e |= {"itl_p95_s", "output_tok_s"}
    assert set(out["metrics"]) == e2e
    models = {s["model"] for s in out["run"]["sampled"]}
    assert models and models <= set(range(4))
    run = out["run"]
    if "unshared" in cell:
        assert run["reused"] == run["reused_expected"] == 0
    else:
        assert run["reused"] > 0 and run["reused_expected"] > 0


def test_trace_run_reports_the_per_layer_metrics_the_cpu_can_read(root):
    """On the CPU nothing runs on a card: the device readers find nothing
    and leave their metric out; the counters', the step's and the host
    tails remain."""
    out = tiny.run(root, CELLS[0], seconds=3.0, trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"sched.decode_batch_mean",
                                   "engine.step_ms", "kv.prefix_hit_pct",
                                   "host.ttft_p95_s", "host.itl_p95_s",
                                   "host.output_tok_s"}
    assert 50 < out["metrics"]["kv.prefix_hit_pct"]["value"] < 100
    assert "busy_s" in out["device"] and "window_s" in out["device"]


def test_a_trace_that_lost_work_is_taken_again(root, monkeypatch):
    """The first stretch's trace has a gap far longer than any step, so
    the run profiles a second stretch later in the window and reports
    that one."""
    from benchlib import devtrace, loop
    traces = [devtrace.DeviceTrace(window_s=0.5, busy_s=0.01,
                                   longest_gap_s=9.0),
              devtrace.DeviceTrace(window_s=0.5, busy_s=0.2,
                                   longest_gap_s=0.01)]
    monkeypatch.setattr(devtrace, "reduce", lambda prof: traces.pop(0))
    monkeypatch.setattr(loop, "TRACE_AT", 0.1)
    monkeypatch.setattr(loop, "TRACE_S", 0.5)
    out = tiny.run(root, CELLS[0], seconds=4.0, trace=True)
    assert out["correct"]
    assert out["run"]["trace_tries"] == 2 and not traces
    assert out["device"]["busy_s"] == 0.2
    assert out["metrics"]["device.idle_pct"]["value"] == pytest.approx(60.0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(root, cell):
    """The reference in float8 e4m3 put in the program's place reads a
    gap past the limit, and the verdict calls it not correct."""
    out = tiny.run(root, cell, control=True)
    assert out["correct"]
    assert out["control_correct"] is False, out["control_checks"]
    assert out["run"]["control_gap"] > out["checks"]["max_gap"]["limit"]


def _no_kv_write():
    """A decode step that leaves the pool as it was."""
    from repro_torch.kernels.paged_decode import paged_decode_attention

    def rows(q, k, v, k_pages, v_pages, block_tables, pos, *, softcap=None,
             rows=None):
        return paged_decode_attention(q.contiguous(), k_pages, v_pages,
                                      block_tables, pos + 1,
                                      softcap=softcap or 0.0)
    return "repro_torch.models.attention.paged_decode_rows", rows


def _altered_token():
    """Each decode step's tokens altered where they are produced."""
    from repro_torch.serving import decode
    orig = decode.next_tokens

    def nxt(logits, seqs, device):
        return [(t + 1) % logits.shape[-1]
                for t in orig(logits, seqs, device)]
    return "repro_torch.serving.decode.next_tokens", nxt


def _half_batch():
    """A chunk forward that leaves half of its batch out: half of its
    rows, or half of the tokens of a single row."""
    from repro_torch.serving.scheduler import scheduler
    orig = scheduler.base_prefill_chunk

    def chunk(cfg, params, toks, *, pool, block_tables, pos):
        if len(toks) > 1:
            k = (len(toks) + 1) // 2
            return orig(cfg, params, toks[:k], pool=pool,
                        block_tables=block_tables[:k], pos=pos[:k])
        half = max(1, len(toks[0]) // 2)
        return orig(cfg, params, [toks[0][:half]], pool=pool,
                    block_tables=block_tables, pos=pos)
    return "repro_torch.serving.scheduler.scheduler.base_prefill_chunk", \
        chunk


def _ends_early():
    """Each request's decode ends three tokens before its length (at
    least one token served), as an abort or a cut under load would."""
    from repro_torch.serving.engine import LocalDisaggEngine
    orig = LocalDisaggEngine._handoff_seq

    def handoff(self, *args, **kwargs):
        seq = orig(self, *args, **kwargs)
        seq.remaining = max(1, seq.remaining - 3)
        return seq
    return ("repro_torch.serving.engine.LocalDisaggEngine._handoff_seq",
            handoff)


@pytest.mark.parametrize("fault", [_no_kv_write, _altered_token,
                                   _half_batch, _ends_early],
                         ids=["state_unchanged", "token_altered",
                              "half_batch", "ends_early"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_correct_false(root, cell, fault,
                                             monkeypatch):
    target, fn = fault()
    monkeypatch.setattr(target, fn)
    out = tiny.run(root, cell)
    assert not out["correct"], out["checks"]
    if fault is _ends_early:
        assert out["checks"]["not_served_in_full"]["value"] > 0


def test_new_cell_config_traffic_and_metric_are_found_by_name(root):
    """A later PR adds a cell as files and BENCHMARK.json entries alone: a
    configuration, a traffic mix (here the reflexion workflow, 4 turns of
    4 agents with short deltas and long answers), a cell and a metric
    reader, each a new file found by its name."""
    sb = root / "servebench"
    cfg = json.loads((sb / "configs/internlm2-1.8b.json").read_text())
    cfg.update(name="wide", num_attention_heads=8, head_dim=8)
    (sb / "configs/wide.json").write_text(json.dumps(cfg))
    mix = json.loads((sb / "traffic/react-agents4.json").read_text())
    mix.update(turns=4, delta_tokens=5, gen_tokens=9)
    (sb / "traffic/reflexion.json").write_text(json.dumps(mix))
    cell = json.loads(
        (sb / "cells/react-agents4.internlm2-1.8b.json").read_text())
    (sb / "cells/reflexion.wide.json").write_text(json.dumps(cell))
    (sb / "metrics/bench.served_per_request.py").write_text(
        "def read(ctx):\n"
        "    return sum(len(r.tokens) for r in ctx.requests) / "
        "len(ctx.requests)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wide", "source": "x",
                             "file": "servebench/configs/wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "reflexion.wide", "config": "wide",
                               "traffic": "reflexion", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "bench.served_per_request",
                                "unit": "tokens", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["reflexion.wide"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny.run(root, "reflexion.wide", seconds=3.0)
    assert out["correct"]
    assert out["metrics"]["bench.served_per_request"]["value"] == 9.0
    assert set(out["metrics"]) == {"req_p95_s", "setup_s",
                                   "bench.served_per_request"}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_on_the_card(card, root, cell):
    """The same tiny float32 cells through the card's kernels: the program
    agrees with the reference, and the float8 control does not."""
    import time

    from benchlib import harness, spec
    out = harness.run_cell(root, spec.load_cell(root, cell),
                           seed=tiny.SEED, seconds=2.0, trace=False,
                           device=card, t_start=time.perf_counter(),
                           control=True)
    assert out["correct"], out["checks"]
    assert out["control_correct"] is False
