"""The sharded dry run on the archs whose layers need their own layout:
MoE routing, the SSD chunked scan, and the backward on three mesh axes.

One subprocess on a fake process group (a process holds one group) traces,
at ``reduced()`` widths and tiny shapes:

- granite-moe-3b-a800m train, prefill and decode on a (2, 4) ``("data",
  "model")`` mesh: the routing's scatter runs on each rank's local rows
  (``models/moe.py`` ``_route_rows``), the expert products stay DTensor
  operations;
- mamba2-780m train and prefill on the same mesh: the chunked scan runs per
  (row, head) shard (``models/ssd.py`` ``_scan_rows``);
- recurrentgemma-2b (four layers: a group and an RG-LRU tail) and
  seamless-m4t-medium (a vocabulary of 66, which the ``model`` axis does
  not divide, as 256206 on 8) train on a (2, 2, 4) ``("pod", "data",
  "model")`` mesh: their backward products keep the token dim off three
  mesh shards (``layers.pin_grad``). A (2, 2, 2) mesh does not reach the
  refused product at these widths; (2, 2, 4) does.

Each case must give a record with no error, positive flops that cover the
single-device trace of the same combo (flops per device times devices),
collectives whose total is the sum of their kinds, and the models' hooks
back to None.

In process, with the hooks None: the routing and the SSD scan are
independent per batch row (and per head), which is what lets the dry run
run them on each rank's shards; a train step of each of these archs never
enters a sharded path, and ``pin_grad`` hands a plain tensor back."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.models import layers
from repro_torch.models import model as model_mod
from repro_torch.models import moe, ssd

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CASES = [("granite-moe-3b-a800m", kind, "2x4")
         for kind in ("train", "prefill", "decode")] \
    + [("mamba2-780m", kind, "2x4") for kind in ("train", "prefill")] \
    + [("recurrentgemma-2b", "train", "2x2x4"),
       ("seamless-m4t-medium", "train", "2x2x4")]

CODE = """
import json, sys
import torch.distributed as dist
from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import attention, model

CASES = json.loads(sys.argv[1])
CONFIGS = {"recurrentgemma-2b": dict(n_layers=4),
           "seamless-m4t-medium": dict(vocab=66)}
SHAPES = {"recurrentgemma-2b": (128, 8), "seamless-m4t-medium": (2048, 8)}
out = {}
for mesh_tag in ("2x4", "2x2x4"):
    mesh = (tmesh.make_host_mesh(model=4, n=8) if mesh_tag == "2x4"
            else tmesh.make_host_mesh(model=4, n=16, pod=2))
    for arch, kind, tag in CASES:
        if tag != mesh_tag:
            continue
        cfg = get_config(arch).reduced(**CONFIGS.get(arch, {}))
        seq, batch = SHAPES.get(arch, (64, 4))
        name = f"tiny_{arch}_{kind}"
        INPUT_SHAPES[name] = InputShape(name, seq, batch, kind)
        key = f"{arch}/{kind}"
        try:
            rec = dryrun.trace(cfg, name, mesh)
            rec["devices"] = mesh.size()
            rec["single_flops"] = dryrun.trace(cfg, name)["cost"]["flops"]
        except Exception as e:
            rec = {"error": f"{type(e).__name__}: {e}"[:300],
                   "where": dryrun._where(e)}
        rec["hooks_none"] = (model.ACTIVATION_SPEC is None
                             and attention.FLASH_KV_SPEC is None)
        out[key] = rec
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    """Every case's record (or error), from one subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run([sys.executable, "-c", CODE, json.dumps(CASES)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,kind,mesh", CASES,
                         ids=[f"{a}-{k}-{m}" for a, k, m in CASES])
def test_sharded_dryrun_lowers(records, arch, kind, mesh):
    rec = records[f"{arch}/{kind}"]
    assert rec["hooks_none"]
    assert "error" not in rec, f"{rec['where']}: {rec['error']}"
    assert set(rec["memory"]) == set(dryrun.MEMORY_KEYS)
    flops = rec["cost"]["flops"]
    assert flops > 0
    # no work dropped: the shards together do at least the single-device
    # step's products (replicated work may make them do more)
    assert flops * rec["devices"] >= rec["single_flops"] > 0
    coll = rec["collectives"]
    assert coll["total"] > 0
    assert coll["total"] == sum(coll["by_op"].values())


# ======================================================================
# in process, hooks None


def test_routing_is_per_row():
    """``_route`` of a batch equals ``_route`` of each row alone, drops
    included (capacity 3 of 12 tokens x top-2 over 4 experts)."""
    g = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn(3, 12, 4, generator=g), -1)
    whole = moe._route(probs, 2, 3)
    assert not bool(whole[2].all())                 # some choices dropped
    rows = [moe._route(probs[b:b + 1], 2, 3) for b in range(3)]
    for i, t in enumerate(whole):
        assert torch.equal(t, torch.cat([r[i] for r in rows])), i


def test_ssd_scan_is_per_row_and_head():
    """``ssd_scan`` of a batch equals the scan of each (row, half of the
    heads) shard alone, to fp32 rounding (the products' batch sizes
    differ)."""
    rng = np.random.default_rng(0)
    Bb, S, H, P, N = 2, 48, 4, 8, 5

    def arr(*shape, lo=None):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.tensor(np.abs(a) * 0.1 + 0.01 if lo else a)
    x, dt, B_, C_ = arr(Bb, S, H, P), arr(Bb, S, H, lo=True), \
        arr(Bb, S, N), arr(Bb, S, N)
    A, init = -arr(H, lo=True), arr(Bb, H, P, N)
    y, final = ssd.ssd_scan(x, dt, A, B_, C_, init, chunk=16)
    for b in range(Bb):
        for hs in (slice(0, 2), slice(2, 4)):
            ys, fs = ssd.ssd_scan(x[b:b + 1, :, hs], dt[b:b + 1, :, hs],
                                  A[hs], B_[b:b + 1], C_[b:b + 1],
                                  init[b:b + 1, hs], chunk=16)
            torch.testing.assert_close(ys, y[b:b + 1, :, hs], atol=1e-6,
                                       rtol=1e-5)
            torch.testing.assert_close(fs, final[b:b + 1, hs], atol=1e-6,
                                       rtol=1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-780m",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-medium"])
def test_hooks_none_train_step_runs_the_plain_paths(arch, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a sharded path ran with the hooks None")
    for mod, name in ((moe, "_route_rows"), (ssd, "_scan_rows"),
                      (model_mod, "_sharded_chunk_nll")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = get_config(arch).reduced(d_model=64, vocab=66)
    monkeypatch.setitem(INPUT_SHAPES, "tiny_plain",
                        InputShape("tiny_plain", 32, 2, "train"))
    b = steps.build(cfg, "tiny_plain")
    assert model_mod.ACTIVATION_SPEC is None
    params, opt_state, batch = steps.materialize(cfg, "tiny_plain", "cpu")
    _, _, loss = b["fn"](params, opt_state, batch)
    assert torch.isfinite(loss)
    t = torch.ones(3)
    assert layers.pin_grad(t) is t


def test_single_device_records(tmp_path, monkeypatch):
    """``--single-device`` writes one-device records (mesh "1", one chip)
    whose flops are the single-device trace's: the figure a sharded
    record's flops x chips must cover."""
    monkeypatch.setitem(INPUT_SHAPES, "tiny_one",
                        InputShape("tiny_one", 64, 2, "decode"))
    out = tmp_path / "one.jsonl"
    assert dryrun.main(["--single-device", "--arch", "internlm2-1.8b",
                        "--shape", "tiny_one", "--out", str(out)]) == 0
    [rec] = [json.loads(line) for line in out.read_text().splitlines()]
    assert (rec["mesh"], rec["chips"]) == ("1", 1)
    want = dryrun.trace(get_config("internlm2-1.8b"), "tiny_one")
    assert rec["cost"] == want["cost"] and rec["cost"]["flops"] > 0
    assert rec["collectives"]["total"] == 0
