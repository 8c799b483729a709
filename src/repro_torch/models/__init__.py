"""repro_torch.models — model zoo of the port (GNN layers in this slice)."""
