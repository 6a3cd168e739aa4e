"""The reduced-precision variants of the impl registry (DESIGN.md §10).

A variant impl maps to (base impl, storage policy). The base impl sets the
execution structure, the policy the storage of the operands:

- ``"bf16"``: values and the dense operand in bfloat16, column ids (and the
  COO row ids) in int16, f32 accumulation in the kernel, the output rounded
  to bfloat16 once and cast back to the caller's dtype;
- ``"i8"``: values as int8 codes with a per-matrix f32 scale applied to the
  f32 accumulator after the reduction, int16 ids, the dense operand and
  the output at the caller's f32.

Only this table and :func:`precision_of` are ported from the reference's
cost model; the ranking behind ``impl="auto"`` is not.
"""
from __future__ import annotations

PRECISION_IMPLS = {
    "ell_bf16": ("ell", "bf16"),
    "csr_bf16": ("csr", "bf16"),
    "pallas_ell_bf16": ("pallas_ell", "bf16"),
    "pallas_csr_bf16": ("pallas_csr", "bf16"),
    "pallas_coo_bf16": ("pallas_coo", "bf16"),
    "pallas_ell_i8": ("pallas_ell", "i8"),
    "pallas_csr_i8": ("pallas_csr", "i8"),
    "fused_bf16": ("fused", "bf16"),
    "pallas_hybrid_bf16": ("pallas_hybrid", "bf16"),
}

POLICIES = ("f32", "bf16", "i8")


def precision_of(impl: str) -> tuple[str, str]:
    """(base impl, storage policy) of any registry impl: ("csr", "bf16")
    for a variant, (impl, "f32") for a full-precision impl."""
    return PRECISION_IMPLS.get(impl, (impl, "f32"))
