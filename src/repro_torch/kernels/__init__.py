"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions.

* :mod:`repro_torch.kernels.bocd_step` — one fused BOCD screening tick.
* :mod:`repro_torch.kernels.cell_reduce` — the simulator's reduction tree.
* :mod:`repro_torch.kernels.flash_decode` — one-token attention over a cache.
* :mod:`repro_torch.kernels.flash_attention` — blocked causal attention.
* :mod:`repro_torch.kernels.ssd_scan` — the Mamba2 SSD chunked scan.

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on the card (or raises); sources live in ``csrc/`` and are
built with ``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
"""
