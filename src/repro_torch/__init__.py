"""FALCON on PyTorch and CUDA — the port of :mod:`repro` to one NVIDIA H100.

The module layout mirrors :mod:`repro` (``repro_torch.core.detector`` is the
twin of ``repro.core.detector``, with the same public names). Host-side
control logic is numpy, carried over unchanged; the two screening/simulator
hot spots run hand-written CUDA kernels (:mod:`repro_torch.kernels`).

Entry points run on the card by default and raise when there is none; pass
``device="cpu"`` (or a CPU-only backend name such as ``"batched"``) to run on
the CPU. See :mod:`repro_torch.device`.
"""
