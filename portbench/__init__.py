"""The benchmark of charon_tpu_torch, the PyTorch and CUDA port
(BENCHMARK.json at the root of the repository; `python3 portbench/run.py`)."""
