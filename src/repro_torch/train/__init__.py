"""Training of the port: optimizer, train step, data, checkpoints."""
