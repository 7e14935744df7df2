"""The benchmark of the PyTorch/CUDA port (`sample_factory_tpu_torch`): `python3 port_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` from the repository's root. Everything that belongs to one model
configuration, one cell, one env or one per-layer metric is a file of its own here, found by its name."""
