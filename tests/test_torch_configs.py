"""The port's architecture registry against the JAX package's: the
reference's eleven arch ids, and for each of them ``FULL`` (``config``),
``SMOKE``, ``family``, ``notes`` and ``cells`` equal the reference's
field for field (``PNAConfig``'s class-level ``aggregators`` too, which
``dataclasses.asdict`` does not see; a transformer's ``dtype`` by name,
``torch.bfloat16`` for ``jnp.bfloat16``), and the lpa-mg8 ``LPAConfig``
equals the reference's. Exact equality throughout: these are shapes,
not numbers computed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import cells as jcells
from repro_torch.configs import registry
from repro_torch.launch import cells

PORTED = ["dcn-v2", "deepseek-v2-lite-16b", "egnn", "equiformer-v2",
          "glm4-9b", "granite-34b", "lpa-mg8", "meshgraphnet", "pna",
          "qwen3-1.7b", "qwen3-moe-235b-a22b"]


def _dtype_name(value):
    """A dtype field as a name: ``torch.bfloat16`` and ``jnp.bfloat16``
    are both ``"bfloat16"``."""
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    return np.dtype(value).name


def _fields(obj):
    """(class name, asdict) of a config dataclass, its dtype by name."""
    fields = dataclasses.asdict(obj)
    if "dtype" in fields:
        fields["dtype"] = _dtype_name(fields["dtype"])
    return type(obj).__name__, fields


def test_ported_ids_and_unported_ones_raise():
    """Every id of the reference is ported; an unknown id raises."""
    assert registry.all_arch_ids() == PORTED == jregistry.all_arch_ids()
    with pytest.raises(KeyError, match="known: "):
        registry.get_arch("gpt-5")


@pytest.mark.parametrize("arch", PORTED)
def test_spec_equals_the_reference(arch):
    ref, got = jregistry.get_arch(arch), registry.get_arch(arch)
    assert got.arch_id == ref.arch_id == arch
    assert got.family == ref.family
    assert got.notes == ref.notes
    assert _fields(got.config) == _fields(ref.config)
    assert _fields(got.smoke) == _fields(ref.smoke)
    assert [dataclasses.asdict(c) for c in got.cells] == \
        [dataclasses.asdict(c) for c in ref.cells]
    for cfg, rcfg in ((got.config, ref.config), (got.smoke, ref.smoke)):
        if arch == "pna":
            assert cfg.aggregators == rcfg.aggregators
        if arch == "equiformer-v2":
            assert cfg.n_sph == rcfg.n_sph
        if arch == "lpa-mg8":
            assert _fields(cfg.lpa) == _fields(rcfg.lpa)


def test_cell_helpers_equal_the_reference():
    assert [dataclasses.asdict(c) for c in registry._lm_cells(" x")] == \
        [dataclasses.asdict(c) for c in jregistry._lm_cells(" x")]
    assert [dataclasses.asdict(c) for c in registry._recsys_cells()] == \
        [dataclasses.asdict(c) for c in jregistry._recsys_cells()]


@pytest.mark.parametrize("arch", ["pna", "meshgraphnet", "egnn",
                                  "equiformer-v2"])
def test_gnn_cell_config_equals_the_reference_cells(arch):
    """d_in/d_out at a cell's width; MeshGraphNet takes d_node_in and 4
    edge features, as the reference's cell builders set it."""
    got = cells._gnn_cell_config(registry.get_arch(arch), 100, 16)
    spec = jregistry.get_arch(arch)
    if arch == "meshgraphnet":
        ref = dataclasses.replace(spec.config, d_node_in=100, d_edge_in=4,
                                  d_out=16)
    else:
        ref = jcells._gnn_cell_config(spec, 100, 16)
    assert _fields(got) == _fields(ref)
