"""Port parity: the LM's sharding rules (``distributed/sharding``:
``param_specs``, ``zero1_specs``, ``cache_specs``, ``to_partition_spec``)
and the mesh hint's divisibility rule (``tuning.constrained_spec``)
against the reference's, in-process and without devices: the rules read
only the mesh's axis names and sizes, so a stand-in mesh of the two
production geometries of ``tests/test_sharding.py`` (16 × 16, and 2 × 16 ×
16 with "pod") serves both packages. Leaf by leaf over every arch, the
port's placements, read back as ``PartitionSpec`` entries, equal the
reference's.
"""
import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.distributed.steps import shaped_params as j_shaped
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import tuning as ttuning
from repro_torch.distributed import lm_mesh, sharding
from repro_torch.distributed.steps import shaped_params as t_shaped
from repro_torch.models import lm as tlm


class _Mesh:
    """The axis names and shape a rule reads, in both packages'
    spellings."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.devices = np.empty(self.shape)


GEOMETRIES = {"16x16": _Mesh(("data", "model"), (16, 16)),
              "2x16x16": _Mesh(("pod", "data", "model"), (2, 16, 16))}


def _norm(entries, ndim):
    """PartitionSpec entries padded to ``ndim``, a 1-tuple as its name."""
    out = list(entries) + [None] * (ndim - len(tuple(entries)))
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in out)


def _ref(specs, shapes):
    """(path, entries) of every leaf of the reference's spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(jsharding._path_str(path), _norm(tuple(s), len(leaf.shape)))
            for (path, leaf), s in zip(flat, leaves, strict=True)]


def _port(specs, shapes, mesh):
    return [(path, _norm(sharding.to_partition_spec(p, mesh, t.ndim),
                         t.ndim))
            for (path, t), p in zip(lm_mesh.leaves_with_paths(shapes),
                                    lm_mesh.spec_leaves(specs), strict=True)]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_lm_rules_match_reference(arch, geometry):
    mesh = GEOMETRIES[geometry]
    jp, tp = j_shaped(jconfigs.get(arch)), t_shaped(tconfigs.get(arch))
    j_specs = jsharding.param_specs(jp, mesh)
    t_specs = sharding.param_specs(tp, mesh)
    assert _port(t_specs, tp, mesh) == _ref(j_specs, jp)
    # ZeRO-1 over the params' specs, and stacked on FSDP's (which must
    # not reuse "data")
    j_fsdp = jsharding.zero1_specs(j_specs, jp, mesh)
    t_fsdp = sharding.zero1_specs(t_specs, tp, mesh)
    assert _port(t_fsdp, tp, mesh) == _ref(j_fsdp, jp)
    assert _port(sharding.zero1_specs(t_fsdp, tp, mesh), tp, mesh) == \
        _ref(jsharding.zero1_specs(j_fsdp, jp, mesh), jp)
    # decode caches: at most one "model" a leaf
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jc = jax.eval_shape(lambda: jlm.init_decode_state(jcfg, 128, 32768))
    tc = tlm.init_decode_state(tcfg, 128, 32768, device="meta")
    got = _port(sharding.cache_specs(tc, mesh), tc, mesh)
    assert got == _ref(jsharding.cache_specs(jc, mesh), jc)
    assert all(list(e).count("model") <= 1 for _, e in got)


@pytest.mark.parametrize("names,shape,x,spec,want", [
    # the reference test's cases: a 1-rank "model" axis divides 7; axes
    # the mesh lacks are dropped
    (("model",), (1,), (7, 16), ("model", None), ("model", None)),
    (("model",), (1,), (7, 16), (("pod", "data"), None), (None, None)),
    # divisible and not on the production geometries
    (("data", "model"), (16, 16), (8, 32), ("data", "model"),
     (None, "model")),
    (("data", "model"), (16, 16), (32, 4, 128),
     (("pod", "data"), "model"), ("data", None, None)),
    (("pod", "data", "model"), (2, 16, 16), (64, 8),
     (("pod", "data"), None), (("pod", "data"), None)),
    (("pod", "data", "model"), (2, 16, 16), (48, 8),
     (("pod", "data"), None), (None, None)),
])
def test_constrained_spec_matches_reference_rule(names, shape, x, spec,
                                                 want):
    t = np.empty(x)
    assert ttuning.constrained_spec(t, *spec) is None    # no mesh hint
    assert ttuning.constrain(t, *spec) is t
    with ttuning.use_mesh_hint(_Mesh(names, shape)):
        assert ttuning.axis_size(names[-1]) == shape[-1]
        assert ttuning.axis_size("nope") is None
        assert ttuning.constrained_spec(t, *spec) == want
        assert ttuning.constrain(t, *spec) is t
    assert ttuning.axis_size("model") is None
