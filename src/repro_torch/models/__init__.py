"""Model layers of the port (the twin of :mod:`repro.models`): dense
attention and Mamba2 stacks; ``moe`` is still to port."""
