from repro_torch.optim.adamw import Optimizer, adamw, cosine_schedule, global_norm

__all__ = ["Optimizer", "adamw", "cosine_schedule", "global_norm"]
