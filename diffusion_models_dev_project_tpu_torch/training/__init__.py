"""Training of score and epsilon priors (losses, EMA, the trainer)."""
