"""The port's sharded dry run (``repro_torch.launch.dryrun``) and its
collective accounting (``launch.commanalysis``), on a fake process group in
a subprocess (a process holds one group): internlm2-1.8b at ``reduced()``
width on a (2, 4) mesh records memory, flops and collectives for tiny
train, prefill and decode shapes; a hand-built column -> row parallel MLP
costs exactly its analytic all-reduce bytes; the production meshes have
the reference's axis names. In process: a resumed sweep skips the combos
it has, and long_500k is a ``skipped`` record for an arch without
sub-quadratic attention."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REDUCED = """
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.launch.commanalysis import StepRecorder, collective_bytes
from repro_torch.models import attention, model

mesh = tmesh.make_host_mesh(model=4, n=8)
cfg = get_config("internlm2-1.8b").reduced()
out = {}
for kind in ("train", "prefill", "decode"):
    INPUT_SHAPES["tiny_" + kind] = InputShape("tiny_" + kind, 64, 4, kind)
    out[kind] = dryrun.trace(cfg, "tiny_" + kind, mesh)
    # the hooks are back to None: serving pays nothing
    assert model.ACTIVATION_SPEC is None and attention.FLASH_KV_SPEC is None

# column -> row parallel MLP, two layers: one all-reduce of (B, S, D) each
B, S, D, F = 2, 16, 32, 64
with FakeTensorMode():
    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.empty(B, S, D, dtype=torch.bfloat16), mesh, rep)
    w1 = distribute_tensor(torch.empty(D, F, dtype=torch.bfloat16), mesh,
                           [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.empty(F, D, dtype=torch.bfloat16), mesh,
                           [Replicate(), Shard(0)])
    rec = StepRecorder()
    with rec:
        for _ in range(2):
            x = ((x @ w1) @ w2).redistribute(placements=rep)
out["mlp"] = collective_bytes(rec.records)
out["mlp_flops"] = rec.flops
print(json.dumps(out))
"""

MESHES = """
import torch.distributed as dist
from repro_torch.launch.mesh import axis_size, data_axes, make_production_mesh
m1 = make_production_mesh()
assert tuple(m1.shape) == (32, 8) and m1.mesh_dim_names == ("data", "model")
assert data_axes(m1) == ("data",) and axis_size(m1, "pod") == 1
dist.destroy_process_group()
m2 = make_production_mesh(multi_pod=True)
assert tuple(m2.shape) == (2, 32, 8)
assert m2.mesh_dim_names == ("pod", "data", "model")
assert data_axes(m2) == ("pod", "data") and axis_size(m2, "model") == 8
print("ok")
"""


@pytest.fixture(scope="module")
def subprocess_lines():
    """The last two lines of one subprocess that runs ``REDUCED``, then
    ``MESHES`` (one interpreter start for both)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    code = REDUCED + "import torch.distributed as dist\n" \
        "dist.destroy_process_group()\n" + MESHES
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return r.stdout.strip().splitlines()[-2:]


def test_reduced_dryrun_and_analytic_collectives_subprocess(subprocess_lines):
    out = json.loads(subprocess_lines[0])
    for kind in ("train", "prefill", "decode"):
        rec = out[kind]
        mem = rec["memory"]
        assert set(mem) == set(dryrun.MEMORY_KEYS), kind
        assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
        assert mem["generated_code_size_in_bytes"] == 0
        assert rec["cost"]["flops"] > 0
        coll = rec["collectives"]
        assert coll["total"] > 0 and coll["loops"] == []
        assert coll["total"] == sum(coll["by_op"].values())
    # the train step and the serving steps rewrite their buffers in place:
    # params + moments, or the cache, alias arguments
    assert out["train"]["memory"]["alias_size_in_bytes"] \
        < out["train"]["memory"]["argument_size_in_bytes"]
    assert out["decode"]["memory"]["alias_size_in_bytes"] > 0
    B, S, D, F = 2, 16, 32, 64
    assert out["mlp"]["by_op"] == {"all-reduce": 2 * (2 * B * S * D * 2)}
    assert out["mlp"]["counts"] == {"all-reduce": 2}
    # per device: the model axis splits F four ways
    assert out["mlp_flops"] == 2 * 2 * (2 * B * S * D * F // 4)


def test_production_meshes_subprocess(subprocess_lines):
    assert subprocess_lines[1] == "ok"


def test_resume_skips_done_combos_and_long_context_skip(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    done = {"arch": "internlm2-1.8b", "shape": "decode_32k", "mesh": "32x8",
            "memory": {}}
    out.write_text(json.dumps(done) + "\n")
    assert dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    assert "cached" in capsys.readouterr().out
    assert dryrun.main(["--arch", "internlm2-1.8b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs[0] == done and len(recs) == 2
    assert recs[1]["skipped"] == dryrun.SKIP_LONG
    assert recs[1]["mesh"] == "32x8"
    assert [c for c in dryrun.combos(["mamba2-780m", "internlm2-1.8b"],
                                     ["long_500k"])] == [
        ("mamba2-780m", "long_500k", None),
        ("internlm2-1.8b", "long_500k", dryrun.SKIP_LONG)]
