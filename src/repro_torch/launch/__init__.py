"""``repro_torch.launch`` — command-line drivers (serving so far)."""
