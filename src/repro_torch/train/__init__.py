"""Training: the train-step builder (gradient accumulation, AdamW)."""
