"""Training: the step, the fused optimizer and the epoch loop."""
