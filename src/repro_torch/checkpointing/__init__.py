from repro_torch.checkpointing.checkpoint import load, save  # noqa: F401
