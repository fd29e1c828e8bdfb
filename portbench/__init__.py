"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, serving on
one H100.  ``python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at
the repository's root names the cells and metrics.  Nothing here imports
JAX or the JAX package."""
