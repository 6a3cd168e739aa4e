"""Performance-tuning flags of the LM zoo and the mesh hint (the
reference's ``tuning.py``).

Flags are a context: a caller sets them around a call with
:func:`use_flags`, model code reads them with :func:`flags`. The fields and
defaults are the reference's, so a ``--tune key=value`` list means the same
in both packages. The port reads every field: ``attention_impl``,
``q_block``, ``kv_block``, ``remat_policy`` (LM training's per-block
checkpoint), ``moe_dispatch``, ``capacity_factor`` (the MoE sublayer),
``mamba_chunk`` (the Mamba2 mixer), ``fsdp`` (the mesh train step shards
parameters over "data") and ``constrain_decode`` (sequence-parallel decode
attention over a mesh's "model" axis). :data:`UNPORTED` names the fields
nothing reads yet, and setting one away from its default raises; it is
empty.

The mesh hint (:func:`use_mesh_hint`) holds the ``DeviceMesh`` the model
code runs on. :func:`axis_size` reads it. :func:`constrained_spec` is the
reference's divisibility rule: the spec ``constrain`` would apply, each
entry kept only where its axes are on the mesh and divide the dim; the
mesh decode reads it to decide whether its attention is
sequence-parallel (``distributed.steps.build_decode_step``). No compiler
reads a layout in the port, so :func:`constrain` returns ``x``
unchanged; the mesh code places its shards itself
(``repro_torch.distributed.lm_mesh``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses


@dataclasses.dataclass(frozen=True)
class TuneFlags:
    # remat policy of the per-block checkpoint: "full" (recompute the
    # block) | "dots" (keep the weight products, recompute the rest) |
    # "none" (no checkpoint)
    remat_policy: str = "full"
    # chunked- and packed-attention block sizes
    q_block: int = 1024
    kv_block: int = 1024
    # MoE dispatch: "grouped" (per-sequence capacity, the default) |
    # "scatter" (one dispatch over the batch) | "sharded_scatter" (the
    # scatter with expert-axis constraints: on one device, the scatter)
    moe_dispatch: str = "grouped"
    # decode: sequence-parallel KV attention over "model" (on a mesh whose
    # caches split their sequence axis; no effect on one device)
    constrain_decode: bool = True
    # attention implementation: "xla_packed" (triangle-packed blocked
    # attention, the default) | "xla_chunked" (plain blocked loop) |
    # "pallas" (the flash-attention kernel; its plain version on the CPU)
    attention_impl: str = "xla_packed"
    # MoE capacity factor
    capacity_factor: float = 1.25
    # FSDP / ZeRO-3: the mesh train step also splits PARAMETERS over "data"
    # (gathered at use)
    fsdp: bool = False
    # Mamba2 chunked scan length; 0 = sequential scan
    mamba_chunk: int = 0


_FLAGS: contextvars.ContextVar[TuneFlags] = contextvars.ContextVar(
    "tune_flags", default=TuneFlags())
_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "mesh_hint", default=None)


# the fields nothing in the port reads yet, and the title of the ROADMAP.md
# queue 1 item that brings their reader
UNPORTED: dict[str, str] = {}


def flags() -> TuneFlags:
    return _FLAGS.get()


@contextlib.contextmanager
def use_flags(**kw):
    new = dataclasses.replace(_FLAGS.get(), **kw)
    for name, item in UNPORTED.items():
        if getattr(new, name) != getattr(TuneFlags, name):
            raise NotImplementedError(
                f"tune flag {name}={getattr(new, name)!r}: nothing in "
                f"repro_torch reads it yet (ROADMAP.md queue 1: {item})")
    tok = _FLAGS.set(new)
    try:
        yield _FLAGS.get()
    finally:
        _FLAGS.reset(tok)


@contextlib.contextmanager
def use_mesh_hint(mesh):
    """Model code under this context runs on ``mesh`` (a ``DeviceMesh``,
    or None for one device)."""
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def axis_size(name: str):
    """Size of a hinted mesh axis, or None outside a mesh-hint context (or
    for an axis the mesh does not have)."""
    mesh = _MESH.get()
    if mesh is None:
        return None
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape)).get(name)


def constrained_spec(x, *spec):
    """The spec :func:`constrain` would apply to ``x`` (anything with a
    ``.shape``): per dim, ``spec``'s entry (None, an axis name or a tuple
    of names) with the axes the mesh lacks dropped, kept only where the
    product of the rest divides the dim (a lone axis as its name), else
    None. None outside a mesh-hint context."""
    mesh = _MESH.get()
    if mesh is None:
        return None
    sizes = dict(zip(mesh.mesh_dim_names or (), mesh.shape))
    parts = list(spec) + [None] * (len(x.shape) - len(spec))
    clean = []
    for dim, part in zip(x.shape, parts):
        axes = () if part is None else tuple(
            a for a in (part if isinstance(part, tuple) else (part,))
            if a in sizes)
        k = 1
        for a in axes:
            k *= sizes[a]
        if axes and dim % k == 0:
            clean.append(axes if len(axes) > 1 else axes[0])
        else:
            clean.append(None)
    return tuple(clean)


def constrain(x, *spec):
    """The reference's best-effort sharding constraint: no compiler reads
    a layout in the port, so ``x`` unchanged (the spec it would apply is
    :func:`constrained_spec`)."""
    return x


def parse_tune_args(pairs: list[str]) -> dict:
    """--tune key=value CLI helper."""
    out = {}
    fields = {f.name: f.type for f in dataclasses.fields(TuneFlags)}
    for pair in pairs or []:
        k, v = pair.split("=", 1)
        if k not in fields:
            raise KeyError(f"unknown tune flag {k}; known: {list(fields)}")
        t = fields[k]
        if t in ("int", int):
            out[k] = int(v)
        elif t in ("float", float):
            out[k] = float(v)
        elif t in ("bool", bool):
            out[k] = v.lower() in ("1", "true", "yes")
        else:
            out[k] = v
    return out
