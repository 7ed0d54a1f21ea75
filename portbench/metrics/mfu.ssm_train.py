"""mfu.ssm_train: ``mfu.train`` in the cells that report
``ssm_train_tokens_per_s``."""
from portbench import bench

read = bench.reader("mfu.train")
