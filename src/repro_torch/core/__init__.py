"""The paper's primary contribution, ported: batched SpMM for GCNs — formats,
the batching planner, the graph-conv layer, ChemGCN, and the giant-graph
tier's CSC sampling structure."""
