"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``): every parameter and cache leaf of
every assigned config and Llama-3.1-8B gets the reference's spec on the
(16, 16) and (32, 8) meshes; the reference's divisibility and cache
properties hold for the port's rules; and, in a subprocess (a fake process
group of 8 ranks beside 8 host devices for jax), the local shard shape each
port placement gives equals the reference's ``NamedSharding.shard_shape``
on a (2, 4) mesh."""
import itertools
import os
import subprocess
import sys

import jax
import pytest

from repro.configs.base import ASSIGNED
from repro.configs.base import get_config as ref_config
from repro.launch import sharding as ref_sharding
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro_torch.launch import sharding

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ASSIGNED + ["llama31-8b"]
MESHES = [(16, 16), (32, 8)]


def shapes(arch):
    """Full-size (name, shape) of every param leaf, and of every cache
    leaf at a decode_32k-like and a long_500k-like (batch 1) shape,
    abstract (nothing is allocated)."""
    cfg = ref_config(arch)
    p = jax.eval_shape(lambda k: ref_init_params(cfg, k), jax.random.PRNGKey(0))
    enc = 1024 if cfg.is_encdec else 0
    caches = [jax.eval_shape(lambda b=b, t=t: ref_init_cache(
        cfg, b, t, enc_len=enc)) for b, t in ((128, 32768), (1, 524288))]

    def named(tree):
        return [(ref_sharding._path_str(path), tuple(leaf.shape))
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]
    return named(p), [leaf for c in caches for leaf in named(c)]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch):
    params, caches = shapes(arch)
    for (data, model), (name, shape) in itertools.product(MESHES, params):
        assert sharding.param_pspec(name, shape, data, model) == tuple(
            ref_sharding.param_pspec(name, shape, data, model)), (name, shape)
    for (data, model), (name, shape), decode in itertools.product(
            MESHES, caches, (False, True)):
        kw = dict(stacked=name.startswith("groups"), decode=decode)
        assert sharding.cache_pspec(name, shape, data, model, **kw) == tuple(
            ref_sharding.cache_pspec(name, shape, data, model, **kw)), (
            name, shape, decode)


def test_sharding_policy_divisibility():
    """No rule may ever produce an uneven shard on the production mesh."""
    shapes_ = [(49155, 1536), (1536, 6448), (40, 1536, 512),
               (8, 6144, 32768), (4096, 4096), (14336, 4096), (2, 46, 128),
               (256000, 4608)]
    for (data, model), shape in itertools.product(MESHES, shapes_):
        for name in ("x/wo", "x/wi", "embed"):
            spec = sharding.param_pspec(name, shape, data, model)
            for dim, ax in itertools.zip_longest(shape, spec, fillvalue=None):
                ways = {"model": model, "data": data}.get(ax)
                if ways:
                    assert dim is not None and dim % ways == 0, (
                        name, shape, spec)


def test_cache_pspec_properties():
    """Every sharded cache dim divides evenly; the stacked leading dim is
    never sharded."""
    pytest.importorskip("hypothesis", reason="optional dep")
    import hypothesis.strategies as st
    from hypothesis import given, settings

    @settings(max_examples=200, deadline=None)
    @given(st.sampled_from(["k", "v", "kpos"]),
           st.sampled_from([1, 2, 8, 32, 128, 256]),
           st.sampled_from([2048, 4096, 32768, 524288]),
           st.sampled_from([64, 256, 1024, 2048]),
           st.booleans(), st.booleans(), st.sampled_from(MESHES))
    def check(leaf, B, T, F, stacked, decode, mesh):
        data, model = mesh
        shape = ((4,) if stacked else ()) + ((B, T) if leaf == "kpos"
                                             else (B, T, F))
        name = ("groups/pos0/" if stacked else "tail/0/") + leaf
        spec = sharding.cache_pspec(name, shape, data, model,
                                    stacked=stacked, decode=decode)
        for dim, ax in zip(shape, spec + (None,) * len(shape)):
            if ax is None:
                continue
            ways = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                ways *= {"data": data, "model": model}[a]
            assert dim % ways == 0, (shape, spec)
        if stacked:
            assert len(spec) == 0 or spec[0] is None

    check()


LOCAL_SHAPES = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro.configs.base import ASSIGNED, get_config as ref_config
from repro.launch import sharding as ref_sharding
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro_torch.launch import mesh as tmesh, sharding

jmesh = jax.make_mesh((2, 4), ("data", "model"))
mesh = tmesh.make_host_mesh(model=4, n=8)
assert tuple(mesh.shape) == (2, 4)

def local(shape, pl):
    return tuple(compute_local_shape_and_global_offset(shape, mesh, pl)[0])

n = 0
for arch in ASSIGNED + ["llama31-8b"]:
    cfg = ref_config(arch)
    p = jax.eval_shape(lambda k: ref_init_params(cfg, k), jax.random.PRNGKey(0))
    c = jax.eval_shape(lambda: ref_init_cache(
        cfg, 4, 64, enc_len=16 if cfg.is_encdec else 0))
    cases = [(p, ref_sharding.params_shardings(p, jmesh, fsdp=f),
              sharding.params_shardings(p, mesh, fsdp=f)) for f in (True, False)]
    cases += [(c, ref_sharding.cache_shardings(c, jmesh, decode=d),
               sharding.cache_shardings(c, mesh, decode=d)) for d in (False, True)]
    for tree, want, got in cases:
        leaves, nss, pls = jax.tree.leaves(tree), jax.tree.leaves(want), PL(got)
        assert len(leaves) == len(nss) == len(pls), arch
        for leaf, ns, pl in zip(leaves, nss, pls):
            assert local(leaf.shape, pl) == tuple(ns.shard_shape(leaf.shape)), (
                arch, leaf.shape, pl, ns.spec)
            n += 1
    for B in (1, 3, 4, 8):
        shape = (B, 64, 32)
        got = local(shape, sharding.batch_sharding(shape, mesh))
        want = ref_sharding.batch_sharding(shape, jmesh).shard_shape(shape)
        assert got == tuple(want), (shape, got, want)
print("ok", n)
"""


def test_local_shard_shapes_equal_reference_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", PL_DEF + LOCAL_SHAPES],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "ok" in r.stdout, (r.stdout + r.stderr)[-3000:]
    assert int(r.stdout.split()[-1]) > 400      # leaves of 11 configs x 4 trees


#: placements at a tree's leaves, in jax's leaf order (dict keys sorted,
#: None dropped): each leaf is a tuple of Placements, which a generic tree
#: walk would take for a container
PL_DEF = '''
from torch.distributed.tensor import Placement

def PL(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in PL(tree[k])]
    if isinstance(tree, (list, tuple)) and tree and all(
            isinstance(p, Placement) for p in tree):
        return [tuple(tree)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in PL(t)]
    return []
'''
