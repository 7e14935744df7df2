"""Seeded device envs of the benchmark's cells: `port_bench/envs/<name>.py` defines `make_env(params)`, which returns a
`sample_factory_tpu_torch.envs.device_env.DeviceEnv` built from the cell's `traffic.env_params`."""
