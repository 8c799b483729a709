"""repro_torch.train — the block model forward (trainers: later slices)."""
