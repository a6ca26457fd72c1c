"""Training: freeze policies, EMA, LR schedules and the trainer."""
