"""AdamW and learning-rate schedules on dicts of tensors."""
