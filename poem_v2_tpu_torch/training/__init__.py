"""Training: optimiser, schedules, the train step and the Trainer."""
