"""Training: losses, optimizer, the train step and evaluation."""
