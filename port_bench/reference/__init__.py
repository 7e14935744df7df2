"""The plain reference of the benchmark's training cells: the actor-critic's forward and the PPO learner in plain
PyTorch, float32 with TF32 off, written from the configuration file alone. It imports nothing of the measured package
or of JAX. A precision other than "float32" (TF32 on, or float8 operands in every product) makes it the control that
the comparison has to fail."""
