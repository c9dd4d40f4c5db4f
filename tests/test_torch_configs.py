"""The port's config registry against the reference's: every config, the
assigned list, the registry's names and each config's ``reduced()``
variant are equal field for field."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro_torch.configs import base as tbase

NAMES = jbase.list_configs()


def test_registry_names_and_assigned_equal_the_reference():
    assert tbase.list_configs() == NAMES
    assert tbase.ASSIGNED == jbase.ASSIGNED
    assert len(NAMES) == 14


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_the_reference(name):
    want = dataclasses.asdict(jbase.get_config(name))
    got = dataclasses.asdict(tbase.get_config(name))
    assert got == want
    assert tbase.get_config(name).param_count() == \
        jbase.get_config(name).param_count()


@pytest.mark.parametrize("kw", [{}, {"n_layers": 3, "d_model": 128,
                                     "vocab": 64}], ids=["default", "narrow"])
@pytest.mark.parametrize("name", NAMES)
def test_reduced_equals_the_reference(name, kw):
    want = jbase.get_config(name).reduced(**kw)
    got = tbase.get_config(name).reduced(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_kinds() == want.layer_kinds()
    assert (got.is_moe, got.is_encdec, got.subquadratic) == \
        (want.is_moe, want.is_encdec, want.subquadratic)


def test_unknown_config_raises_like_the_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("no-such-arch")
