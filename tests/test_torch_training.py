"""The port's training stack against the reference's.

Optimizer (AdamW with its schedules, bf16 moments and the global clip) over
5 steps on a small tree; the data pipeline byte for byte; checkpoints both
ways (each package reads the other's ``.npz`` + ``.json``); five
``finetune_cache_conditioned`` steps and ``evaluate`` from a bridged init
(the reference's weights carried across with ``params_from_numpy``); and
the launcher on the CPU. Tolerances are stated at each check.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.core.lora import LoRAPair as JLoRAPair
from repro.models import init_params as jax_init_params
from repro.training import data as JD
from repro.training import optim as jopt
from repro.training import trainer as jtrainer
from repro.training.checkpoint import load as jax_load
from repro.training.checkpoint import save as jax_save
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core.lora import LoRAPair
from repro_torch.params import params_from_numpy, tree_leaves, tree_map
from repro_torch.training import data as TD
from repro_torch.training import optim as topt
from repro_torch.training import trainer as ttrainer
from repro_torch.training.checkpoint import load, save

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(name="t", arch_type="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32")
SPEC = dict(domain="copy", n_symbols=8, prompt_len=6, vocab=64)


def _tree(seed, dtype=np.float32):
    """A small tree of matrices (decayed), a stacked 3-D leaf (decayed) and
    vectors (not decayed), a list among them."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(dtype),
            "stack": rng.standard_normal((2, 3, 2)).astype(dtype),
            "b": rng.standard_normal((3,)).astype(dtype),
            "tail": [rng.standard_normal((5,)).astype(dtype)]}


def _opts(kind, mod, moment):
    """The same optimizer in either package."""
    lr = {"const": 3e-2, "cosine": mod.warmup_cosine(5e-2, 5,
                                                     warmup_ratio=0.4)}[kind]
    return mod.AdamW(lr, weight_decay=0.1, moment_dtype=moment,
                     grad_clip=0.5 if kind == "cosine" else 0.0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["const", "cosine"])
def test_adamw_steps_match_reference(kind, moments):
    """Five AdamW steps from the same params and gradients: params, both
    moments and the step counter agree within 1e-6 (relative and absolute;
    bias corrections and the schedule's cosine are scalar ops each side
    rounds on its own), bf16 moments included; ``cosine`` clips the global
    gradient norm."""
    jo = _opts(kind, jopt, jnp.dtype(moments))
    to = _opts(kind, topt, getattr(torch, moments))
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = params_from_numpy(_tree(0), "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _tree(10 + step)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(params_from_numpy(g, "cpu"), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    assert int(ts.step) == int(js.step) == 5
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert g.dtype == getattr(torch, str(w.dtype))
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=1e-6, atol=1e-6)


def test_bf16_params_update_in_their_dtype():
    """A bf16 parameter gets its update cast to bf16 and added in bf16:
    bit-equal to the reference."""
    jo, to = jopt.AdamW(1e-2), topt.AdamW(1e-2)
    p = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)}
    g = {"w": np.linspace(0.5, -0.25, 12, dtype=np.float32).reshape(3, 4)}
    jp = {"w": jnp.asarray(p["w"], jnp.bfloat16)}
    tp = {"w": torch.tensor(p["w"]).to(torch.bfloat16)}
    ju, _ = jo.update({"w": jnp.asarray(g["w"], jnp.bfloat16)}, jo.init(jp),
                      jp)
    tu, _ = to.update({"w": torch.tensor(g["w"]).to(torch.bfloat16)},
                      to.init(tp), tp)
    out = topt.apply_updates(tp, tu)["w"]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.float().numpy(),
        np.asarray(jopt.apply_updates(jp, ju)["w"], np.float32))


def test_schedules_match_reference():
    """warmup_cosine and constant_lr over and past the schedule, within
    1e-7 relative."""
    for args in ((1e-3, 100), (2e-3, 10), (1e-3, 100, 0.1, 0.05)):
        js, ts = jopt.warmup_cosine(*args), topt.warmup_cosine(*args)
        for step in (0, 1, 2, 3, 9, 10, 11, 50, 99, 100, 150):
            np.testing.assert_allclose(float(ts(torch.tensor(step))),
                                       float(js(step)), rtol=1e-7)
    assert float(topt.constant_lr(3e-4)(7)) == float(jopt.constant_lr(3e-4)(7))


@pytest.mark.parametrize("domain", JD.DOMAINS)
def test_batches_byte_equal(domain):
    for seed in (0, 7):
        spec = dict(SPEC, domain=domain)
        for a, b in zip(JD.batches(seed, JD.TaskSpec(**spec), 5, 3),
                        TD.batches(seed, TD.TaskSpec(**spec), 5, 3)):
            for f in ("prompt", "target_in", "target_out", "target_mask"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    jcfg = ModelConfig(**CFG)
    for a, b in zip(jtrainer.pretrain_batches(jcfg, 3, 2, 4),
                    ttrainer.pretrain_batches(TModelConfig(**CFG), 3, 2, 4)):
        assert a.keys() == b.keys()
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def _ckpt_trees():
    """A tree with a bf16 leaf, an int leaf, a list and an adapter pair,
    in each package's types."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    bf = rng.standard_normal((4,)).astype(np.float32)
    pa, pb = (rng.standard_normal((3, 2)).astype(np.float32)
              for _ in range(2))
    jt = {"a": jnp.asarray(a), "n": {"bf": jnp.asarray(bf, jnp.bfloat16),
                                     "i": jnp.arange(3, dtype=jnp.int32)},
          "lst": [jnp.asarray(pa), jnp.asarray(pb)],
          "lora": {"wq": JLoRAPair(jnp.asarray(pa), jnp.asarray(pb)),
                   "wk": None}}
    tt = {"a": torch.tensor(a),
          "n": {"bf": torch.tensor(bf).to(torch.bfloat16),
                "i": torch.arange(3, dtype=torch.int32)},
          "lst": [torch.tensor(pa), torch.tensor(pb)],
          "lora": {"wq": LoRAPair(torch.tensor(pa), torch.tensor(pb)),
                   "wk": None}}
    return jt, tt


def _equal(ttree, jtree):
    gl, wl = tree_leaves(ttree), jax.tree.leaves(jtree)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_checkpoint_port_reads_reference(tmp_path):
    jt, tt = _ckpt_trees()
    jax_save(str(tmp_path / "ref"), jt, meta={"step": 3})
    got = load(str(tmp_path / "ref"), tree_map(torch.zeros_like, tt))
    assert isinstance(got["lora"]["wq"], LoRAPair) and got["lora"]["wk"] is None
    _equal(got, jt)


def test_checkpoint_reference_reads_port(tmp_path):
    jt, tt = _ckpt_trees()
    save(str(tmp_path / "port"), tt, meta={"step": 3})
    ref_json = (tmp_path / "ref.json")
    jax_save(str(tmp_path / "ref"), jt, meta={"step": 3})
    assert (tmp_path / "port.json").read_text() == ref_json.read_text()
    _equal(tt, jax_load(str(tmp_path / "port"), jt))


def test_checkpoint_load_checks_shapes(tmp_path):
    _, tt = _ckpt_trees()
    save(str(tmp_path / "c"), tt)
    like = tree_map(torch.zeros_like, tt)
    like["a"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="shape mismatch at a"):
        load(str(tmp_path / "c"), like)


def _bridged():
    jcfg = ModelConfig(**CFG)
    jb, jd = (jax_init_params(jcfg, jax.random.PRNGKey(s)) for s in (0, 1))
    return (jcfg, TModelConfig(**CFG), jb, jd,
            *(params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
              for p in (jb, jd)))


def test_finetune_cache_conditioned_matches_reference_step_by_step():
    """Five Eq. 7 AdamW steps (the reference's Trainer, jit-compiled, against
    the port's plain loop) from the same decoder and base: every step's
    loss within 1e-5 relative. The final parameters: at least 99.9% of
    the elements within 1e-5 (relative and absolute), and all within
    1e-4. Adam divides each moment by its own root mean square, so a
    component whose gradient is at rounding level (the two sides'
    gradients agree to ~1e-6 of their largest, tests/test_torch_train_
    losses.py) moves by up to lr per step on either side: such elements,
    not the implementation, set the tail. Then ``evaluate``'s accuracy
    per token on the shared cache and exact at share ratio 0.5, equal to
    the reference's."""
    jcfg, tcfg, jb, jd, tb, td = _bridged()
    kw = dict(seed=4, steps=5, batch=6, lr=1e-3)
    jp, jl = jtrainer.finetune_cache_conditioned(
        jcfg, jd, jb, "copy", spec=JD.TaskSpec(**SPEC), **kw)
    tp, tl = ttrainer.finetune_cache_conditioned(
        tcfg, td, tb, "copy", spec=TD.TaskSpec(**SPEC), **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = np.concatenate([g.numpy().ravel() for g in tree_leaves(tp)])
    want = np.concatenate([np.asarray(w).ravel()
                           for w in jax.tree.leaves(jp)])
    close = np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)
    assert close.mean() >= 0.999, (close.size - close.sum(), close.size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for share, per_token in ((1.0, True), (0.5, False)):
        ekw = dict(seed=2, batches=2, batch=8, share_ratio=share,
                   per_token=per_token)
        assert ttrainer.evaluate(tcfg, tp, tb, "copy",
                                 spec=TD.TaskSpec(**SPEC), **ekw) == \
            jtrainer.evaluate(jcfg, jp, jb, "copy",
                              spec=JD.TaskSpec(**SPEC), **ekw)


def test_finetune_full_matches_reference():
    """Three full fine-tuning steps: losses within 1e-5 relative."""
    jcfg, tcfg, _, jd, _, td = _bridged()
    kw = dict(seed=5, steps=3, batch=4, lr=1e-3)
    _, jl = jtrainer.finetune_full(jcfg, jd, "lookup",
                                   spec=JD.TaskSpec(**dict(SPEC,
                                                           domain="lookup")),
                                   **kw)
    _, tl = ttrainer.finetune_full(tcfg, td, "lookup",
                                   spec=TD.TaskSpec(**dict(SPEC,
                                                           domain="lookup")),
                                   **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_launcher_needs_a_card_unless_given_the_cpu():
    """Without ``--device`` the launcher runs on the card, and with no card
    it raises before building anything (no fallback to the CPU)."""
    from repro_torch.launch import train as launch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--reduced", "--pretrain-steps", "1", "--steps", "1"])


def test_launcher_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --reduced`` with 2 +
    2 steps writes both checkpoints, and the reference's ``load`` reads
    them into the reduced config's tree."""
    out = tmp_path / "ckpt"
    # two threads: the suite's other workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--device", "cpu", "--reduced", "--pretrain-steps",
                        "2", "--steps", "2", "--batch", "8", "--out",
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "shared-cache accuracy" in r.stdout
    from repro.configs.base import get_config
    like = jax_init_params(get_config("internlm2-1.8b").reduced(vocab=64),
                           jax.random.PRNGKey(0))
    for stem in ("ckpt_base", "ckpt_copy"):
        tree = jax_load(str(tmp_path / stem), like)
        assert all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(tree))
