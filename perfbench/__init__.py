"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
run of one cell is ``python3 perfbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``; ``BENCHMARK.json`` lists the cells."""
