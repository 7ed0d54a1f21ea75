"""Shared by the benchmark's CPU tests: one thread a worker, and the
benchmark's own cells cut to a size the CPU holds in seconds.

The cuts keep the cell's limits meaningful: the Mamba2 cell keeps 8 layers
(with 2, the control's gradient gap stays under the limit the full width
needs), and the serving cell keeps the published attention width, whose
logit scale the served-token gap is measured in."""
import copy

import pytest
import torch

from portbench import bench


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and these tests' many small operations slow down by tens of
    times when every worker spins a thread per core."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def small():
    """``small(name)``: the cell ``name`` of ``BENCHMARK.json`` cut in depth,
    width and length."""
    return _small


def _small(name: str) -> bench.Cell:
    c = bench.cell(name)
    conf = copy.deepcopy(c.config)
    if c.traffic["driver"] == "serve":
        conf.update(intermediate_size=1024, num_hidden_layers=2, vocab_size=500)
        c.traffic = dict(c.traffic, batch=2, prompt_len=48, gen=16)
    elif conf["architecture"] == "granite":
        conf.update(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                    num_key_value_heads=2, num_hidden_layers=2, vocab_size=500)
        c.traffic = dict(c.traffic, seq_len=64)
    else:
        conf.update(d_model=256, n_layer=8, vocab_size=1000)
        conf["assumed"] = dict(conf["assumed"], d_state=32, headdim=32, chunk_size=32)
        c.traffic = dict(c.traffic, seq_len=128)
    c.config = conf
    return c
