"""The training driver, :mod:`portbench.drivers.train`, under the name of the
mixes whose configurations hold a share of a mixture of experts
(``train-8k``). The shared small-size fixture of the benchmark's CPU tests
(``portbench/conftest.py``) cuts only the granite and mamba2 configurations
of the ``train`` cells; these cells' small-size checks are in
``portbench/test_portbench_moe.py``, with a cut of their own.

Temporary: once ``conftest.py`` cuts a ``granitemoehybrid`` configuration,
``train-8k`` names the driver ``train`` again, this module goes, and
``test_portbench_moe.py`` folds into ``test_portbench_train.py`` and
``test_portbench_spans.py``."""
from portbench.drivers.train import Run, run, study  # noqa: F401
