"""A plain float32 PyTorch reference of the configurations the benchmark runs:
the port's models, operations and train steps as a frozen copy, with the
kernel dispatch removed.  It imports nothing of the port."""
