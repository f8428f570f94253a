from repro_torch.checkpoint.io import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
