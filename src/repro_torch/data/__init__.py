from repro_torch.data.pipeline import ShardedLoader, synthetic_stream  # noqa: F401
