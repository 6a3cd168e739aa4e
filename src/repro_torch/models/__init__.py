"""GNN layers on the g-SpMM message-passing primitive (GAT, R-GCN)."""
