"""Model layers of the port (the twin of :mod:`repro.models`): dense
attention stacks; ``ssm`` and ``moe`` come with the training slice."""
