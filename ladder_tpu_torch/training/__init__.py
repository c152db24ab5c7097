"""Training: schedules, the per-group optimiser, the losses and the train
step of the port."""
