"""Training: ``GCNTrainer``, ChemGCN over batched SpMM with Adam and
resumable checkpoints."""
