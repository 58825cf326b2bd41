from repro_torch.optim.adamw import adamw, clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
