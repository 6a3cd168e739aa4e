"""Distribution on one device: the train step builder (``steps``) and int8
error-feedback gradient compression (``compression``). The mesh half of
the reference's package (sharding rules, pipeline, the sharded SpMM, the
prefill and decode step builders) is not ported yet (ROADMAP.md queue 1:
sharding and the distributed stack)."""
