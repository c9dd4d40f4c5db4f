"""Rule catalog for the port's torch code: serving invariants as AST checks.

The ids and bug classes are the reference's (``repro.analysis.rules``);
the triggers are the torch idiom's:

- RPR001 donation-after-use — the torch form of a dead donated buffer: a
  static input of a CUDA-graph capture (a name the body of ``with
  torch.cuda.graph(g):`` reads) is rebound by assignment, then the graph
  is replayed. The replay reads the storage captured, never the new
  tensor, so the step silently runs on stale inputs; refill a static input
  with ``copy_``. (``make_graphed_callables`` copies its inputs into its
  own static buffers at each call, so only a captured block can go stale.)
- RPR002 refcount-balance — a function takes pool references
  (``alloc``/``ref``/``acquire``/``begin``/``extend``) and then performs
  fallible work with no ``unref``/``drop``/``release``/``abandon`` on any
  exception path: one raise and the pages leak as permanently-active.
  (Unchanged from the reference, as is its relay-publication note: the
  runtime half is the sanitizer's census.)
- RPR003 host-sync-in-hot-path — ``.item()``/``.tolist()``/``.cpu()``/
  ``.numpy()``/``torch.cuda.synchronize()``/``np.asarray``/``float(x[i])``
  inside scheduler/decode step loops (``HOT_FUNCS``, which adds
  ``next_tokens``, the decode plane's one token read-back) waits for the
  card and serializes the pipeline per step (or worse, per token).
- RPR004 unbucketed-shape-into-jit — a runtime length (``len``, ``.shape``,
  or a ``max``/``min``/``sum`` over runtime values) reaches the shape of a
  ``zeros/full/empty/ones`` or an entry without the pow2 bucketing helper.
  Entries: ``torch.compile`` targets, ``make_graphed_callables`` results,
  and the ``step``/``_step`` names, called or defined (a step body is what
  a CUDA-graph capture keys on): each new shape is a recompile or a new
  capture.
- RPR005 side-effect-in-jit — Python side effects (``self.x += 1``,
  ``print``, ``time.*``) inside a ``torch.compile``d function (decorated or
  passed) or the body of a ``torch.cuda.graph`` capture run at trace or
  capture time only: counters stop counting after the first call.
- RPR006 metrics-instrument-in-step — registry ``counter``/``gauge``/
  ``histogram`` get-or-create inside per-step code; instruments must be
  hoisted to ``__init__``/``_init_metrics`` so hot paths hold direct refs.
- RPR007 host-materialized-pool-pages — ``.cpu()``/``.to("cpu")``/
  ``.numpy()``/``.tolist()``/``np.asarray`` on the paged pool's page
  tensors anywhere outside ``kvcache/swap.py``. The swap tier is the ONE
  sanctioned device->host path for pool KV (timed, fed to the preemption
  cost model, censused by the sanitizer); an ad-hoc host copy elsewhere
  serializes the card against the whole pool and produces KV the swap
  census cannot account for.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       attr_chain, call_name, receiver_name,
                                       walk_calls)

# pool-ish receivers: method calls on these names are refcount operations
_POOLISH = re.compile(r"^(pool|mgr|manager|block_pool|blockpool)$")
ACQUIRE_METHODS = {"alloc", "ref", "acquire", "begin", "extend", "retain"}
# swap_out / discard_swapped are the swap tier's release-side transitions
# (device rows relinquished to the pool's SWAPPED/FREE populations): a
# rollback handler that re-parks reclaimed pages IS release discipline
RELEASE_METHODS = {"unref", "drop", "release", "abandon", "swap_out",
                   "discard_swapped"}

# calls that cannot plausibly raise between an acquire and its release
_SAFE_CALLS = {"append", "extend", "touch", "record_hit", "move_to_end",
               "setdefault", "get", "pop", "popitem", "items", "keys",
               "values", "add", "remove", "discard", "int", "len", "str",
               "float", "bool", "max", "min", "list", "tuple", "dict", "set",
               "sorted", "range", "hash", "isinstance", "copy", "enumerate",
               "zip"}

# names of the pow2 bucketing helpers that make a dynamic shape
# capture-safe
BUCKET_HELPERS = {"next_pow2", "pow2_bucket", "bucket_pow2"}

# step entry points by convention: the engine's decode steps are stored,
# called and defined as ``step``/``_step`` (StackedDecoders.step, a
# worker's ``_step``) — plus anything assigned from torch.compile(...) or
# make_graphed_callables(...)
_ENTRY_NAMES = {"step", "_step"}

# functions that ARE the per-step hot path (RPR003/RPR006 scope): decode and
# chunk-packing loops of the scheduler/engine/decode plane, and the decode
# plane's token read-back
HOT_FUNCS = {"step", "decode_step", "_decode_phase", "_batched_step",
             "_run_chunks", "_grow_tail_pages", "_promote", "_plan_chunks",
             "_reap_finished", "next_tokens"}
_HOT_CLASS = re.compile(r"(Scheduler|Engine|Plane|Decoder|Worker)")


def _functions(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _is_compile(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return chain[-2:] == ["torch", "compile"] or chain == ["compile"]


def _is_graphed(call: ast.Call) -> bool:
    return call_name(call) == "make_graphed_callables"


def _is_capture(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g):`` (or ``cuda.graph(g)``)."""
    e = item.context_expr
    return (isinstance(e, ast.Call)
            and attr_chain(e.func)[-2:] == ["cuda", "graph"])


def _captures(node):
    """Every ``with`` statement under ``node`` that captures a CUDA
    graph, with the graph's dotted name ('' when not a name chain)."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                if _is_capture(item):
                    args = item.context_expr.args
                    yield sub, ".".join(attr_chain(args[0])) if args else ""


def _dotted(node, ctx_type) -> set:
    """Dotted names (``x``, ``self.buf``) of every Name/Attribute under
    ``node`` in the given context (Load or Store)."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)) \
                and isinstance(sub.ctx, ctx_type):
            chain = attr_chain(sub)
            if chain:
                out.add(".".join(chain))
    return out


def _entry_assignments(ctx: ModuleContext) -> set:
    """Last name of every target assigned from ``torch.compile(...)`` or
    ``make_graphed_callables(...)`` in the module."""
    out = set()
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)
                and (_is_compile(node.value) or _is_graphed(node.value))):
            continue
        chain = attr_chain(node.targets[0])
        if chain:
            out.add(chain[-1])
    return out


# ======================================================================
class DonationAfterUse(Rule):
    rule_id = "RPR001"
    title = "donation-after-use"

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for fn in _functions(ctx):
            for cap, graph in _captures(fn):
                findings.extend(self._check_capture(ctx, fn, cap, graph))
        return findings

    def _check_capture(self, ctx, fn, cap, graph):
        stored = set().union(*(_dotted(st, ast.Store) for st in cap.body))
        static = set().union(*(_dotted(st, ast.Load) for st in cap.body)) \
            - stored - {graph}
        end = (getattr(cap, "end_lineno", cap.lineno),
               getattr(cap, "end_col_offset", 0))
        events = sorted(
            (n for n in ast.walk(fn)
             if isinstance(n, (ast.Assign, ast.Call))
             and (n.lineno, n.col_offset) > end),
            key=lambda n: (n.lineno, n.col_offset))
        rebound: dict = {}
        findings = []
        for node in events:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    for name in _dotted(tgt, ast.Store) & static:
                        rebound.setdefault(name, node)
                continue
            if call_name(node) == "replay" and (
                    not graph or ".".join(attr_chain(node.func)[:-1])
                    == graph):
                for name, site in sorted(rebound.items()):
                    findings.append(self.finding(
                        ctx, site,
                        f"'{name}' is a static input of the CUDA graph "
                        f"captured on line {cap.lineno} and is rebound "
                        f"before '{graph or 'graph'}.replay()' on line "
                        f"{node.lineno} — the replay reads the captured "
                        f"storage, not the new tensor; refill it with "
                        f"{name}.copy_(...)"))
                    static.discard(name)
                rebound.clear()
        return findings


# ======================================================================
class RefcountBalance(Rule):
    rule_id = "RPR002"
    title = "refcount-balance"
    applies_to_tests = False        # tests corrupt pools on purpose

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for fn in _functions(ctx):
            acquires = []
            has_release_handler = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Try):
                    guarded = list(node.finalbody)
                    for h in node.handlers:
                        guarded.extend(h.body)
                    for g in guarded:
                        for c in walk_calls(g):
                            if (call_name(c) in RELEASE_METHODS
                                    and (_POOLISH.match(receiver_name(c))
                                         or receiver_name(c) == "self")):
                                has_release_handler = True
            for c in walk_calls(fn):
                if (call_name(c) in ACQUIRE_METHODS
                        and _POOLISH.match(receiver_name(c))):
                    acquires.append(c)
            if not acquires or has_release_handler:
                continue
            first = min(acquires,
                        key=lambda c: (c.lineno, c.col_offset))
            risky = [
                c for c in walk_calls(fn)
                if (c.lineno, c.col_offset) > (first.lineno, first.col_offset)
                and call_name(c) not in _SAFE_CALLS
                and not (call_name(c) in ACQUIRE_METHODS
                         and _POOLISH.match(receiver_name(c)))
                and not (call_name(c) in RELEASE_METHODS
                         and _POOLISH.match(receiver_name(c)))]
            if risky:
                findings.append(self.finding(
                    ctx, first,
                    f"'{receiver_name(first)}.{call_name(first)}(...)' takes "
                    f"pool references but the enclosing function performs "
                    f"fallible work afterwards (e.g. "
                    f"'{call_name(risky[0])}(...)' on line "
                    f"{risky[0].lineno}) with no unref/drop/release/abandon "
                    f"on any exception path — a raise leaks the pages as "
                    f"permanently active"))
        return findings


# ======================================================================
def _is_numpy_asarray(c: ast.Call) -> bool:
    return call_name(c) == "asarray" and receiver_name(c) in ("np", "numpy",
                                                              "onp")


class HostSyncInHotPath(Rule):
    rule_id = "RPR003"
    title = "host-sync-in-hot-path"
    applies_to_tests = False

    _READBACKS = {"item": ".item()", "tolist": ".tolist()",
                  "cpu": ".cpu()", "numpy": ".numpy()"}

    def _is_readback(self, node) -> bool:
        return (isinstance(node, ast.Call) and call_name(node) in
                self._READBACKS and not node.args and not node.keywords
                and isinstance(node.func, ast.Attribute))

    def _is_hot(self, ctx, fn) -> bool:
        if fn.name not in HOT_FUNCS:
            return False
        cls = ctx.enclosing_class(fn)
        if cls is not None and _HOT_CLASS.search(cls.name):
            return True
        return "serving/" in ctx.path

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for fn in _functions(ctx):
            if not self._is_hot(ctx, fn):
                continue
            for c in walk_calls(fn):
                name = call_name(c)
                if self._is_readback(c):
                    if self._is_readback(c.func.value):
                        continue          # one copy: the chain's first call
                    findings.append(self.finding(
                        ctx, c, f"{self._READBACKS[name]} on a device "
                        f"tensor in a per-step hot path waits for the card "
                        f"and copies to the host"))
                elif attr_chain(c.func)[-2:] == ["cuda", "synchronize"]:
                    findings.append(self.finding(
                        ctx, c, "torch.cuda.synchronize() in a per-step hot "
                        "path serializes the device pipeline every step"))
                elif _is_numpy_asarray(c):
                    findings.append(self.finding(
                        ctx, c, "np.asarray in a per-step hot path copies "
                        "device memory to host synchronously"))
                elif (name in ("float", "int") and len(c.args) == 1
                        and isinstance(c.args[0], ast.Subscript)):
                    findings.append(self.finding(
                        ctx, c, f"{name}() on an indexed (device) value in "
                        f"a per-step hot path forces one device->host sync "
                        f"per element"))
        return findings


# ======================================================================
class UnbucketedShapeIntoJit(Rule):
    rule_id = "RPR004"
    title = "unbucketed-shape-into-jit"

    @staticmethod
    def _runtime(node) -> bool:
        """An argument that is runtime data: not a constant and not rooted
        at self (self attributes are stable across steps)."""
        if isinstance(node, ast.Constant):
            return False
        chain = attr_chain(node)
        return not (chain and chain[0] == "self")

    @classmethod
    def _dynamic_len(cls, expr) -> bool:
        """Expression derives a length from runtime data: a ``len(x)``, a
        ``max``/``min``/``sum`` over runtime values, or a ``.shape``."""
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call) and sub.args:
                name = call_name(sub)
                if name == "len" and cls._runtime(sub.args[0]):
                    return True
                if name in ("max", "min", "sum") and any(
                        cls._runtime(a) for a in sub.args):
                    return True
            if isinstance(sub, ast.Attribute) and sub.attr == "shape":
                return True
        return False

    @staticmethod
    def _bucketed(expr) -> bool:
        return any(isinstance(sub, ast.Call)
                   and call_name(sub) in BUCKET_HELPERS
                   for sub in ast.walk(expr))

    def check(self, ctx: ModuleContext) -> list[Finding]:
        entries = _entry_assignments(ctx) | _ENTRY_NAMES
        findings = []
        for fn in _functions(ctx):
            is_entry = fn.name in _ENTRY_NAMES or any(
                call_name(c) in entries for c in walk_calls(fn))
            if not is_entry:
                continue
            shape_vars: dict[str, ast.Assign] = {}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and self._dynamic_len(node.value)
                        and not self._bucketed(node.value)):
                    shape_vars[node.targets[0].id] = node
            if not shape_vars:
                continue
            flagged: set[str] = set()
            for c in walk_calls(fn):
                if call_name(c) not in entries | {"zeros", "full", "empty",
                                                  "ones"}:
                    continue
                for a in list(c.args) + [k.value for k in c.keywords]:
                    for sub in ast.walk(a):
                        if (isinstance(sub, ast.Name)
                                and isinstance(sub.ctx, ast.Load)
                                and sub.id in shape_vars
                                and sub.id not in flagged):
                            flagged.add(sub.id)
                            findings.append(self.finding(
                                ctx, shape_vars[sub.id],
                                f"'{sub.id}' is a runtime length that "
                                f"reaches a step's tensor shapes without "
                                f"pow2 bucketing (next_pow2) — compiled "
                                f"or captured steps will grow with the "
                                f"data instead of O(log)"))
        return findings


# ======================================================================
class SideEffectInJit(Rule):
    rule_id = "RPR005"
    title = "side-effect-in-jit"

    _IMPURE_ROOTS = {"time", "random"}

    def _compiled_defs(self, ctx: ModuleContext):
        """FunctionDefs that torch.compile traces: passed by name to
        torch.compile, or decorated with torch.compile /
        torch.compile(...) / partial(torch.compile, ...); nested defs
        too."""
        compiled: set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and _is_compile(node) and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Name):
                    compiled.add(a0.id)
        targets = []
        for fn in _functions(ctx):
            if fn.name in compiled:
                targets.append(fn)
                continue
            for dec in fn.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                chain = attr_chain(d)
                if chain[-2:] == ["torch", "compile"] or chain == ["compile"]:
                    targets.append(fn)
                    break
                if isinstance(dec, ast.Call) and chain[-1:] == ["partial"]:
                    if any(attr_chain(a)[-2:] == ["torch", "compile"]
                           for a in dec.args):
                        targets.append(fn)
                        break
        out, seen = [], set()
        for fn in targets:
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and id(sub) not in seen:
                    seen.add(id(sub))
                    out.append(sub)
        return out

    @staticmethod
    def _walk_own(node):
        """Walk node's body, pruning nested defs — each nested def is its
        own entry in the target list, so its body is visited once."""
        stack = list(ast.iter_child_nodes(node))
        while stack:
            sub = stack.pop()
            yield sub
            if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(sub))

    def check(self, ctx: ModuleContext) -> list[Finding]:
        bodies = [(fn, "a torch.compile'd function")
                  for fn in self._compiled_defs(ctx)]
        bodies += [(cap, "a CUDA-graph capture")
                   for cap, _ in _captures(ctx.tree)]
        findings, seen = [], set()
        for body, where in bodies:
            for node in self._walk_own(body):
                if id(node) in seen:
                    continue
                seen.add(id(node))
                findings.extend(self._effects(ctx, node, where))
        findings.sort(key=lambda f: (f.line, f.col))
        return findings

    def _effects(self, ctx, node, where):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            return [self.finding(
                ctx, node,
                f"assignment to '{'.'.join(chain)}' inside {where} runs "
                f"once per trace or capture, not per call — hoist the side "
                f"effect out of it")
                for chain in map(attr_chain, tgts)
                if len(chain) >= 2 and chain[0] == "self"]
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            return [self.finding(
                ctx, node, f"global/nonlocal mutation inside {where} runs "
                f"once per trace or capture")]
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if call_name(node) == "print":
                return [self.finding(
                    ctx, node, f"print inside {where} fires once per trace "
                    f"or capture, never on a replay")]
            if chain and chain[0] in self._IMPURE_ROOTS:
                return [self.finding(
                    ctx, node,
                    f"'{'.'.join(chain)}(...)' inside {where} is evaluated "
                    f"at trace or capture time only")]
        return []


# ======================================================================
class MetricsInstrumentInStep(Rule):
    rule_id = "RPR006"
    title = "metrics-instrument-in-step"
    applies_to_tests = False

    _ALLOWED_FUNCS = {"__init__", "_init_metrics", "__post_init__"}
    _RECEIVER = re.compile(r"(^reg$|registry$)")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and call_name(node) in ("counter", "gauge", "histogram")
                    and self._RECEIVER.search(receiver_name(node))):
                continue
            fn = ctx.enclosing_function(node)
            if fn is None or fn.name in self._ALLOWED_FUNCS:
                continue
            findings.append(self.finding(
                ctx, node,
                f"registry.{call_name(node)}(...) get-or-create inside "
                f"'{fn.name}' — instruments must be hoisted to __init__/"
                f"_init_metrics so per-step code holds direct references"))
        return findings


# ======================================================================
class HostMaterializedPoolPages(Rule):
    rule_id = "RPR007"
    title = "host-materialized-pool-pages"
    applies_to_tests = False        # tests assert on host copies on purpose

    #: the one sanctioned device->host path for pool page KV
    _SANCTIONED = "kvcache/swap.py"
    #: names that identify an expression as pool page state: the pool's
    #: page tensors, the pool object itself, and the whole-pool tree
    #: accessor the swap tier gathers from
    _POOL_TOKENS = {"k_groups", "v_groups", "k_tail", "v_tail",
                    "kvpool", "kv_pool", "pool_state"}
    _METHODS = ("cpu", "numpy", "tolist")

    @staticmethod
    def _to_cpu(c: ast.Call) -> bool:
        """``.to("cpu")``, ``.to(device="cpu")``, ``.to(torch.device("cpu"))``."""
        vals = list(c.args[:1]) + [k.value for k in c.keywords
                                   if k.arg == "device"]
        for v in vals:
            if isinstance(v, ast.Call) and call_name(v) == "device" \
                    and v.args:
                v = v.args[0]
            if isinstance(v, ast.Constant) and v.value == "cpu":
                return True
        return False

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if ctx.path.replace("\\", "/").endswith(self._SANCTIONED):
            return []
        findings = []
        for c in walk_calls(ctx.tree):
            name = call_name(c)
            if _is_numpy_asarray(c):
                sources = list(c.args) + [k.value for k in c.keywords]
            elif isinstance(c.func, ast.Attribute) and (
                    name in self._METHODS
                    or (name == "to" and self._to_cpu(c))):
                sources = [c.func.value]
            else:
                continue
            toks: set[str] = set()
            for a in sources:
                for sub in ast.walk(a):
                    if isinstance(sub, ast.Name):
                        toks.add(sub.id)
                    elif isinstance(sub, ast.Attribute):
                        toks.add(sub.attr)
            if toks & self._POOL_TOKENS:
                findings.append(self.finding(
                    ctx, c,
                    f"'{name}(...)' materializes pool page tensors on the "
                    f"host outside {self._SANCTIONED} — the swap tier is "
                    f"the one sanctioned device->host path for pool KV "
                    f"(timed for the preemption cost model, censused by the "
                    f"sanitizer); an ad-hoc host copy serializes the device "
                    f"pipeline and escapes the swap census"))
        return findings


ALL_RULES = [DonationAfterUse(), RefcountBalance(), HostSyncInHotPath(),
             UnbucketedShapeIntoJit(), SideEffectInJit(),
             MetricsInstrumentInStep(), HostMaterializedPoolPages()]

RULES_BY_ID = {r.rule_id: r for r in ALL_RULES}
