"""optimizer_pct.ssm_train: ``optimizer_pct.train`` in the cells that
report ``ssm_train_tokens_per_s``."""
from portbench import bench

read = bench.reader("optimizer_pct.train")
