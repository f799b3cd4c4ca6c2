"""Training of the port: the train step, checkpoints and the fault-tolerant loop."""
