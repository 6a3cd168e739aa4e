"""Data pipelines: synthetic molecular graphs (ChemGCN) and LM token
batches."""
