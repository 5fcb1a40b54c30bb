"""repro_torch.runtime: fault tolerance for the training loop."""
