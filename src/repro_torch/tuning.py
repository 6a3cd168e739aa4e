"""Performance-tuning flags of the LM zoo (the reference's ``tuning.py``).

Flags are a context: a caller sets them around a call with
:func:`use_flags`, model code reads them with :func:`flags`. The fields and
defaults are the reference's, so a ``--tune key=value`` list means the same
in both packages. The reference's mesh hint (``use_mesh_hint``,
``axis_size``, ``constrain``) is not ported: on one device its calls are
the identity, and the port leaves them out (ROADMAP.md queue 1: sharding
and the distributed stack).
The port reads ``attention_impl``, ``q_block``, ``kv_block``,
``remat_policy`` (LM training's per-block checkpoint), ``moe_dispatch``,
``capacity_factor`` (the MoE sublayer) and ``mamba_chunk`` (the Mamba2
mixer); setting any other field away from its default raises
``NotImplementedError`` until the code that reads it is ported.
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
    # decode: sequence-parallel KV constraints (the identity on one device)
    constrain_decode: bool = True
    # attention implementation: "xla_packed" (triangle-packed blocked
    # attention, the default) | "xla_chunked" (plain blocked loop) |
    # "pallas" (the flash-attention kernel; its plain version on the CPU)
    attention_impl: str = "xla_packed"
    # MoE capacity factor
    capacity_factor: float = 1.25
    # parameter sharding over the data axis (multi-device, not ported)
    fsdp: bool = False
    # Mamba2 chunked scan length; 0 = sequential scan
    mamba_chunk: int = 0


_FLAGS: contextvars.ContextVar[TuneFlags] = contextvars.ContextVar(
    "tune_flags", default=TuneFlags())


# the fields nothing in the port reads yet, and the title of the ROADMAP.md
# queue 1 item that brings their reader
UNPORTED = {"constrain_decode": "sharding and the distributed stack",
            "fsdp": "sharding and the distributed stack"}


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
