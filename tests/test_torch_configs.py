"""Config parity: the port's copy of the registry equals ``repro.configs``
field by field, for every full and smoke config."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import repro.configs as jcfg
import repro_torch.configs as tcfg


def test_registry_and_shapes_match():
    assert tcfg.list_archs() == jcfg.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    assert tcfg.cells(include_skipped=True) == \
        jcfg.cells(include_skipped=True)


@pytest.mark.parametrize("arch", jcfg.list_archs())
@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_config_fields_match(arch, which):
    j = getattr(jcfg, which)(arch)
    t = getattr(tcfg, which)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.hd, t.sub_quadratic, t.is_attention_free) == \
        (j.hd, j.sub_quadratic, j.is_attention_free)
    assert t.n_params() == j.n_params()
    assert t.n_params(active_only=True) == j.n_params(active_only=True)
    for name in ("param_dt", "compute_dt"):
        td, jd = getattr(t, name)(), getattr(j, name)()
        assert isinstance(td, torch.dtype)
        assert str(td).removeprefix("torch.") == jnp.dtype(jd).name
