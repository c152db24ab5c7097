"""portbench: the benchmark of ladder_tpu_torch, the PyTorch and CUDA port
of LaDDer, on NVIDIA H100 cards.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

runs one cell once from the root of a checkout and prints one JSON line
last on standard output: whether the timed path's outputs matched the
plain reference (``correct``), the requests or steps attempted and failed,
the cell's metrics and the device. ``harness.py`` says how a cell is
found; ``reference/`` holds the plain PyTorch reference, ``yardstick.py``
the arithmetic of operations, bytes, peaks and traces, ``seeded.py`` the
inputs made from the seed, ``checks.py`` the comparison that decides
``correct``. ``python -m portbench.control`` reads the lower-precision
control on given seeds; ``python -m portbench.sweep`` finds a serving
cell's knee. Nothing here imports JAX or the JAX package.
"""
