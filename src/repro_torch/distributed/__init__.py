"""Distribution: the train step builder (``steps``, one device), int8
error-feedback gradient compression (``compression``), and the
data-parallel GCN half of the reference's package: the mesh-sharded batched
SpMM, g-SpMM and fused layer (``spmm``) and the batch sharding rule
(``sharding.batch_specs``). The LM half (the parameter, cache and ZeRO
rules, ``pipeline``, the prefill and decode step builders) is not ported
yet (ROADMAP.md queue 1: sharding and the distributed stack)."""
