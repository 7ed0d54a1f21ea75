"""peak_gib.ssm_train: ``peak_gib.train`` in the cells that report
``ssm_train_tokens_per_s``."""
from portbench import bench

read = bench.reader("peak_gib.train")
