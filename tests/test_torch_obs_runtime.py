"""The port's runtime spans (``repro_torch.obs.runtime``): the trees the
trainer, the train step, the control plane and the serve loop open, self
time, the cost when off, and the spans in a profiler's trace."""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tconfigs
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train as tlaunch
from repro_torch.launch.serve import serve
from repro_torch.models import model as model_lib
from repro_torch.obs import runtime
from repro_torch.train import trainer as ttrainer


@pytest.fixture(autouse=True)
def clean_record():
    runtime.reset()
    yield
    runtime.reset()


def _cfg():
    return replace(tconfigs.get_config("falcon-demo-100m").smoke(), dtype="float32")


def _trainer(tmp_path):
    cfg = _cfg()
    data = tpipeline.DataConfig(seq_len=16, global_batch=2, slots=2, dp_groups=1)
    return ttrainer.FalconTrainer(
        cfg=cfg, data=data, perf_model=tlaunch.train_simulator(cfg, data, device="cpu"),
        ckpt_dir=str(tmp_path), device="cpu")


def _parents():
    """(name, ids, parent name) of every recorded span: the parent is the
    shortest span of the same track that encloses it."""
    spans = [(i, track, name, ts, ts + dur, args)
             for i, (ph, track, name, ts, dur, args) in enumerate(runtime.tracer().events())
             if ph == "X"]
    out = []
    for i, track, name, a, b, args in spans:
        enclosing = [(e - s, n) for j, t, n, s, e, _ in spans
                     if j != i and t == track and s <= a and b <= e]
        out.append((name, args, min(enclosing)[1] if enclosing else None))
    return out


def test_one_trainer_step_opens_the_listed_tree(tmp_path):
    tr = _trainer(tmp_path)
    with runtime.recording():
        tr.run(1)
    got = _parents()
    counts = {}
    for name, _, _ in got:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"train.step": 1, "train.batch": 1, "train.compute": 1,
                      "train.forward": 2, "train.backward": 2, "train.optimizer": 1,
                      "falcon.model": 1, "falcon.observe": 1, "falcon.detect": 1,
                      "falcon.plan": 1}
    parent = {name: p for name, _, p in got}
    assert parent == {"train.step": None, "train.batch": "train.step",
                      "train.compute": "train.step", "train.forward": "train.compute",
                      "train.backward": "train.compute", "train.optimizer": "train.compute",
                      "falcon.model": "train.step", "falcon.observe": "train.step",
                      "falcon.detect": "falcon.observe", "falcon.plan": "falcon.observe"}
    assert sorted(a["slot"] for n, a, _ in got if n == "train.forward") == [0, 1]
    assert [a for n, a, _ in got if n == "train.step"] == [{"step": 0}]
    assert {t for _, t, *_ in runtime.tracer().events()} == {("host", "trainer")}
    # train.compute is the region step_seconds times, from the same clock reads.
    t = runtime.totals()
    assert t["train.compute"]["host_s"] == tr.step_seconds[-1]
    if not torch.cuda.is_initialized():
        assert all(v["device_s"] is None for v in t.values())


def test_serve_opens_a_prefill_and_a_decode_tree_per_token():
    cfg = _cfg()
    params = model_lib.init_params(cfg, 0, device="cpu")
    with runtime.recording():
        res = serve(cfg, params, np.zeros((2, 8), np.int64), gen=4, device="cpu")
    got = _parents()
    assert [n for n, _, p in got if p is None] == ["serve.batch"]
    assert [n for n, _, p in got if p == "serve.batch"] == ["serve.prefill"] + ["serve.decode"] * 4
    assert [a["token"] for n, a, _ in got if n == "serve.decode"] == [0, 1, 2, 3]
    children = [n for n, _, p in got if p == "serve.decode"]
    assert children == ["serve.dispatch", "serve.wait", "falcon.observe", "serve.sample"] * 4
    assert {t for _, t, *_ in runtime.tracer().events()} == {("host", "serve")}
    t = runtime.totals()
    assert t["serve.prefill"]["host_s"] == res.prefill_s
    ev = [e for e in runtime.tracer().events()]
    dispatch = [(ts, ts + d) for _, _, n, ts, d, _ in ev if n == "serve.dispatch"]
    wait = [(ts, ts + d) for _, _, n, ts, d, _ in ev if n == "serve.wait"]
    assert res.step_s == [w[1] - d[0] for d, w in zip(dispatch, wait)]


def test_self_time_is_duration_less_children():
    tr = runtime.tracer()
    a, b = ("host", "trainer"), ("host", "serve")
    # Recorded as spans close: children before their parent.
    tr.span(a, "leaf", 1.0, 2.0)
    tr.span(a, "leaf", 2.5, 3.0)
    tr.span(a, "mid", 0.5, 4.0)
    tr.span(a, "leaf", 4.5, 5.0)
    tr.span(a, "root", 0.0, 10.0)
    tr.span(b, "other", 1.0, 9.0)          # another track: no parent of these
    tr.span(a, "root", 10.0, 12.0)         # a sibling touching the first root
    t = runtime.totals()
    assert t["leaf"] == {"count": 3, "host_s": 2.0, "self_s": 2.0, "device_s": None}
    assert t["mid"]["host_s"] == 3.5 and t["mid"]["self_s"] == 2.0
    assert t["root"]["count"] == 2 and t["root"]["host_s"] == 12.0
    assert t["root"]["self_s"] == pytest.approx(12.0 - 3.5 - 0.5)
    assert t["other"]["self_s"] == 8.0


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(runtime, "record_function", lambda name: entered.append(name))
    assert not runtime.enabled()
    first = runtime.span("train.step", step=0)
    with first as s:
        with runtime.span("train.batch"):
            pass
    assert s is first is runtime.span("serve.decode", token=3)   # one shared no-op
    with runtime.timed("train.compute") as c:
        pass
    assert c.seconds >= 0.0
    assert entered == [] and len(runtime.tracer()) == 0 and runtime.totals() == {}


def test_spans_are_user_annotations_in_the_profilers_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tr = _trainer(tmp_path)
    cfg = _cfg()
    params = model_lib.init_params(cfg, 0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert runtime.enabled()
        tr.run(1)
        serve(cfg, params, np.zeros((2, 8), np.int64), gen=2, device="cpu")
    assert not runtime.enabled()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    annotated = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    names = set(runtime.totals())
    assert names == {"train.step", "train.batch", "train.compute", "train.forward",
                     "train.backward", "train.optimizer", "falcon.model", "falcon.observe",
                     "falcon.detect", "falcon.plan", "serve.batch", "serve.prefill",
                     "serve.decode", "serve.dispatch", "serve.wait", "serve.sample"}
    assert names <= annotated


def test_a_span_open_across_a_reset_closes_into_the_old_record():
    with runtime.recording():
        with runtime.span("serve.batch"):
            old = runtime.tracer()
            runtime.reset()
    assert len(old) == 1 and len(runtime.tracer()) == 0


def _moe_cfg(**kw):
    return replace(tconfigs.get_config("granite-4.0-h-small").smoke(), dtype="float32", **kw)


def test_moe_spans_nest_under_the_forward_and_its_recompute():
    """The dropless MoE's spans open inside ``train.forward`` and, in the
    recompute of a sub-layer's checkpoint, inside ``train.backward``: each
    of one period's ten layers' three spans once in each, a slot (one
    intra-op thread: many small operations beside the suite's other
    workers)."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = _moe_cfg(num_layers=10)
    params = model_lib.init_params(cfg, 0, device="cpu")
    params = torch.utils._pytree.tree_map(lambda t: t.float(), params)
    step = make_train_step(cfg, adamw.AdamWConfig())
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 32), generator=torch.Generator().manual_seed(0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with runtime.recording():
            step(params, adamw.init(params), {"tokens": toks, "labels": toks.roll(-1, -1)})
    finally:
        torch.set_num_threads(threads)
    got = {}
    for name, _, parent in _parents():
        if name.startswith("moe."):
            got[(name, parent)] = got.get((name, parent), 0) + 1
    assert got == {(n, p): 2 * cfg.num_layers for n in ("moe.route", "moe.experts", "moe.combine")
                   for p in ("train.forward", "train.backward")}


def test_a_counter_off_costs_a_flag_check():
    class Untouchable:
        def detach(self):
            raise AssertionError("an off counter read its value")

    assert not runtime.enabled()
    runtime.count("moe.held_routed", Untouchable())
    assert runtime.counts() == {}


def test_counter_sums_equal_the_routed_count_of_a_seeded_layer():
    """Experts 1 and 2 of 4 held: the counter's sum is the choices routed to
    them, its max the busier one's; ``within`` keeps what a span held."""
    from repro_torch.models import layers, moe

    cfg = _moe_cfg(held_experts=2, expert_offset=1)
    p = {k: v[0].float() for k, v in
         model_lib.init_params(cfg, 1, device="cpu")["blocks"]["sub0"]["moe"].items()}
    x = torch.randn((2, 48, cfg.d_model), generator=torch.Generator().manual_seed(4))
    with runtime.recording():
        moe.apply_moe(p, x, cfg)
        with runtime.span("train.forward"):
            moe.apply_moe(p, x, cfg)
    hn = layers.rmsnorm(x, p["norm"], cfg.norm_eps).reshape(96, -1)
    _, idx, _ = moe.route(layers.matmul(hn, p["router"]), cfg.top_k, n_real=cfg.num_experts)
    per = [int((idx == e).sum()) for e in (1, 2)]
    assert runtime.counts() == {"moe.held_routed": {"ticks": 2, "sum": 2 * sum(per),
                                                     "max": max(per)}}
    assert runtime.counts(within="train.forward")["moe.held_routed"]["sum"] == sum(per)
    assert runtime.counts(within="serve.batch") == {}
