"""Batched serving: ``ServeEngine`` (LM decode waves) and
``GraphServeEngine``, the per-wave ChemGCN executor."""
