"""PyTorch/CUDA port of sample_factory_tpu: the same config flags, trajectory schema and
PPO numerics, with the JAX package's Pallas kernels rewritten as CUDA kernels for Hopper.
Imports torch only; nothing of jax, flax, optax or sample_factory_tpu."""
