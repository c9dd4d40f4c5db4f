"""Serving-invariant static analyzer for the port's torch code
(stdlib-only; needs neither torch nor jax to run).

Port of ``repro.analysis``: the core, baseline and CLI are copies, the
rules (``rules.py``) are rewritten for the torch idiom under the same ids.
Usage: ``python -m repro_torch.analysis src/repro_torch tests chip_smoke.py
--baseline .analysis-baseline-torch.json``; README "Static analysis of the
port" has the rule catalog and the baselining workflow.
"""
from repro_torch.analysis.baseline import (apply_baseline, load_baseline,
                                           save_baseline)
from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       analyze_paths, fingerprint_findings,
                                       iter_python_files, parse_module)
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

__all__ = ["Finding", "ModuleContext", "Rule", "analyze_paths",
           "fingerprint_findings", "iter_python_files", "parse_module",
           "ALL_RULES", "RULES_BY_ID", "apply_baseline", "load_baseline",
           "save_baseline"]
