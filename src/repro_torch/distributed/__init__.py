"""Distribution: the train, prefill and decode step builders (``steps``,
on one device or a mesh), int8 error-feedback gradient compression
(``compression``), the sharding rules (``sharding``: data inputs, LM
parameters, ZeRO-1 state, decode caches), the LM's mesh mechanics
(``lm_mesh``: shards, gathers and the tensor-parallel pair) and the
data-parallel GCN path (``spmm``: the mesh-sharded batched SpMM, g-SpMM
and fused layer). The pipeline schedule is not ported yet (ROADMAP.md
queue 1: distributed/pipeline)."""
