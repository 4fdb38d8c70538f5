"""Parameter initialisation; the optimizers are ROADMAP slice 2."""
