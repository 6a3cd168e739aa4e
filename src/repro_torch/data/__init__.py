"""Data pipelines: synthetic molecular graphs (ChemGCN)."""
