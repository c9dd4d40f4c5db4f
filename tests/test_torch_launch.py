"""The port's serving and analytic launchers against the reference's.

- ``launch.analytic.step_analytic`` equals the reference's for every
  assigned config and input shape (exact dict equality).
- ``launch.serve --engine sim`` prints the reference's JSON when the
  reference's figures are patched in (tests/test_torch_simulator.py's
  patch, plus 16e9 bytes a chip).
- ``launch.serve --engine local --device cpu`` on weights carried across
  from the reference's ``init_params(cfg, PRNGKey(0))`` and
  ``PRNGKey(3 + i)`` prints the reference's turns (context lengths,
  generated tokens) and hit ratio; without ``--device`` and with no card
  it raises.
"""
import contextlib
import functools
import io
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED, INPUT_SHAPES
from repro.configs import get_config as jget
from repro.configs.base import ModelConfig as JModelConfig
from repro.launch import analytic as JA
from repro.launch import serve as JSERVE
from repro.models import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.launch import analytic as TA
from repro_torch.launch import serve as TSERVE
from repro_torch.params import params_from_numpy
from test_torch_simulator import REF_SCFG, patch_reference_figures


@pytest.mark.parametrize("name", ASSIGNED)
def test_step_analytic_equals_reference(name):
    for shape in INPUT_SHAPES:
        assert TA.step_analytic(tget(name), shape) == \
            JA.step_analytic(jget(name), shape), (name, shape)


@pytest.mark.parametrize("mode", ["baseline", "prefillshare"])
def test_serve_sim_prints_reference_json(monkeypatch, capsys, mode):
    patch_reference_figures(monkeypatch)
    monkeypatch.setattr(TSERVE, "HBM_BYTES", 16e9)
    monkeypatch.setattr(TSERVE, "ServingConfig",
                        functools.partial(TSERVE.ServingConfig, **REF_SCFG))
    argv = ["--engine", "sim", "--sessions", "12", "--rate", "6",
            "--mode", mode]
    TSERVE.main(argv)
    got = capsys.readouterr().out
    JSERVE.run_sim(TSERVE.parser().parse_args(argv))
    want = capsys.readouterr().out
    assert '"sessions_done": 12' in want
    assert got == want


LOCAL = ["--engine", "local", "--turns", "1", "--gen", "4"]


@pytest.fixture(scope="module")
def reference_local_output():
    """The reference launcher's local engine run, and its weights."""
    args = TSERVE.parser().parse_args(LOCAL)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JSERVE.run_engine(args)
    cfg = JModelConfig(**{f: getattr(TSERVE.TOY, f)
                          for f in TSERVE.TOY.__dataclass_fields__})
    base = jinit(cfg, jax.random.PRNGKey(0))
    decs = {f"agent{i}": jinit(cfg, jax.random.PRNGKey(3 + i))
            for i in range(args.agents)}
    return buf.getvalue(), (base, decs)


def test_serve_local_cpu_prints_reference_turns(reference_local_output,
                                                capsys):
    want, (jbase, jdecs) = reference_local_output

    def carried(cfg, agents, device):
        assert sorted(jdecs) == [f"agent{i}" for i in range(agents)]

        def conv(p):
            return params_from_numpy(jax.tree.map(np.asarray, p), device)
        return conv(jbase), {m: conv(p) for m, p in jdecs.items()}

    args = TSERVE.parser().parse_args(LOCAL + ["--device", "cpu"])
    TSERVE.run_engine(args, build_weights=carried)
    got = capsys.readouterr().out
    lines = want.splitlines()
    assert len(lines) == 4 and lines[-1].startswith("hit_ratio=")
    assert got.splitlines() == lines


def test_serve_local_default_device_is_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setattr(sys, "argv", ["serve"] + LOCAL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSERVE.main()
