"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions.

* :mod:`repro_torch.kernels.bocd_step` — one fused BOCD screening tick.
* :mod:`repro_torch.kernels.cell_reduce` — the simulator's reduction tree.

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on the card (or raises); sources live in ``csrc/`` and are
built with ``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
"""
