"""The autotune's registry axis, ported: which impls are reduced-precision
variants of which base impl. The cost model, selector and tuning cache
(``impl="auto"``) are not ported yet."""
from repro_torch.autotune.cost_model import (  # noqa: F401
    PRECISION_IMPLS,
    precision_of,
)
