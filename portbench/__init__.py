"""The benchmark of ``shwd_torch``, the PyTorch and CUDA port, on NVIDIA
H100 cards: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once and prints one JSON line.
``BENCHMARK.json`` at the root of the repository lists the cells."""
