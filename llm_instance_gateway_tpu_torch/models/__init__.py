"""Model architecture configs, layers-stacked transformer, LoRA slots."""
