"""repro_torch.data: the synthetic LM stream and the AMU-prefetching
loader."""
