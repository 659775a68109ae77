"""The benchmark of the PyTorch/CUDA port: ``python3 benchmark_torch/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
