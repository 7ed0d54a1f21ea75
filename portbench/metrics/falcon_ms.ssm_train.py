"""falcon_ms.ssm_train: ``falcon_ms.train`` in the cells that report
``ssm_train_tokens_per_s``."""
from portbench import bench

read = bench.reader("falcon_ms.train")
