"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on H100s:
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, driven by ``BENCHMARK.json``."""
