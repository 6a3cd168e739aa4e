"""Data pipelines: synthetic molecular graphs (ChemGCN), the giant
node-classification graph of the sampled tier, and LM token batches."""
