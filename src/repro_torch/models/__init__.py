"""Models: the GNN layers on the g-SpMM message-passing primitive (GAT,
R-GCN) and the LM zoo's dense decoder-only path (layers, lm)."""
