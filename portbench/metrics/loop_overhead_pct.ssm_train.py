"""loop_overhead_pct.ssm_train: ``loop_overhead_pct.train`` in the cells that report
``ssm_train_tokens_per_s``."""
from portbench import bench

read = bench.reader("loop_overhead_pct.train")
