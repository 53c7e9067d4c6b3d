"""Training: config, optimizer, checkpoints, metrics, loop, CLI."""
