"""The training substrate: the synthetic token stream, AdamW and the
checkpointed train loop (port of `repro.training`)."""
