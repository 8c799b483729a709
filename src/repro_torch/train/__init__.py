"""repro_torch.train — the full-graph trainer (``gnn.train_gnn``) and the
block model forward that serving runs (``gnn_minibatch``)."""
