"""segbench: the benchmark of segtpu_torch, the PyTorch/CUDA port of segtpu.

Run a cell from the root of a checkout on a machine with an NVIDIA GPU::

    python3 -m segbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``segbench/README.md`` describes the layout and how to add a configuration,
a traffic mix, a cell or a per-layer metric.
"""
