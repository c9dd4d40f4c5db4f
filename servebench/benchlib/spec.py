"""The benchmark's data files, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; each has a file of its own under ``servebench/``:

  - a cell:          ``servebench/cells/<cell>.json`` (its client count and
                     correctness limits)
  - a configuration: ``servebench/configs/<config>.json`` (the published
                     sizes, as run, plus the engine's settings)
  - a traffic mix:   ``servebench/traffic/<mix>.json`` (parameters of the
                     one generator, ``benchlib/traffic.py``)
  - a metric:        ``servebench/metrics/<metric>.py`` (a ``read(ctx)``)
  - a reference:     ``servebench/reference/<name>.py`` (named by the
                     configuration)

Nothing here knows any particular cell.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

#: the folder of the harness's data, relative to the checkout's root
BENCH_DIR = "servebench"

#: configuration-file key -> ``repro_torch.configs.base.ModelConfig`` field
CONFIG_KEYS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "torch_dtype": "dtype",
}


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that is missing or
    malformed."""


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with every file it names loaded."""
    name: str
    entry: dict            # its ``workloads`` entry
    params: dict           # servebench/cells/<name>.json
    config: dict           # servebench/configs/<config>.json
    traffic: dict          # servebench/traffic/<traffic>.json
    end_to_end: list       # the BENCHMARK.json metric entries it reports
    per_layer: list


def _reported(metrics: list, cell: str, e2e_names: set | None) -> list:
    """Metrics a cell reports: those that list it under ``workloads``, and
    those without the key (per-layer ones only where the cell reports the
    end-to-end metric they move)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e_names is None or m.get("moves") in e2e_names:
            out.append(m)
    return out


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(entries)})")
    entry = entries[name]
    base = root / BENCH_DIR
    params = _load_json(base / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if params.get(key, entry[key]) != entry[key]:
            raise SpecError(f"cell {name}: {key} {params[key]!r} in its file "
                            f"but {entry[key]!r} in BENCHMARK.json")
    config = _load_json(base / "configs" / f"{entry['config']}.json")
    traffic = _load_json(base / "traffic" / f"{entry['traffic']}.json")
    e2e = _reported(bench["end_to_end"], name, None)
    per_layer = _reported(bench["per_layer"], name,
                          {m["name"] for m in e2e})
    return Cell(name, entry, params, config, traffic, e2e, per_layer)


def model_config(config: dict):
    """The port's ``ModelConfig`` for a configuration file: the registered
    config named ``port_config`` with every size the file states put in
    (the file is what runs)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(config["port_config"])
    updates = {CONFIG_KEYS[k]: v for k, v in config.items()
               if k in CONFIG_KEYS}
    return dataclasses.replace(cfg, **updates)


def hparams(config: dict) -> dict:
    """The plain sizes the reference reads (no object of the port)."""
    d = config["hidden_size"]
    return {
        "n_layers": config["num_hidden_layers"],
        "d_model": d,
        "n_heads": config["num_attention_heads"],
        "n_kv_heads": config["num_key_value_heads"],
        "head_dim": config.get("head_dim",
                               d // config["num_attention_heads"]),
        "d_ff": config["intermediate_size"],
        "vocab_size": config["vocab_size"],
        "rope_theta": float(config["rope_theta"]),
        "norm_eps": float(config["rms_norm_eps"]),
        "tie_embeddings": bool(config["tie_word_embeddings"]),
    }


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier
    (``metrics/kern.paged_decode_roofline.py``)."""
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """``read(ctx)`` of ``servebench/metrics/<name>.py``."""
    mod = load_module(Path(root) / BENCH_DIR / "metrics" / f"{name}.py",
                      f"servebench_metric_{name.replace('.', '_')}")
    return mod.read


def reference_module(root: Path, config: dict):
    """The plain reference the configuration names."""
    ref = config["reference"]
    return load_module(Path(root) / BENCH_DIR / "reference" / f"{ref}.py",
                       f"servebench_reference_{ref}")


def peaks(root: Path, device_name: str) -> dict | None:
    """The published peaks of ``device_name`` (``servebench/peaks.json``), or
    None for a device the table does not hold (the CPU)."""
    table = _load_json(Path(root) / BENCH_DIR / "peaks.json")
    return table["devices"].get(device_name)
