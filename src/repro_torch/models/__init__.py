"""repro_torch.models — the dense decoder of the model wing, in PyTorch."""
