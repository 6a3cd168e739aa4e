"""Batched serving: ``GraphServeEngine``, the per-wave ChemGCN executor."""
