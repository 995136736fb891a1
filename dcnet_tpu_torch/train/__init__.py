"""Port training: optimizer and state, the train/eval steps, the epoch loop."""
