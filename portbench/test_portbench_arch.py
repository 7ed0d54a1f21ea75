"""Architectures as files of their own (``portbench/reference/arch/``).

The readings of the two architectures the benchmark runs equal those the
harness gave when both were written into the shared modules (commit
55a279dbd9816b0293c8cf41d5e16096313f26ca, seed ``SEED``): the sizes, the
sorted spec, the port's configuration, the yardstick's counts, every
drawn leaf bit for bit, and the reference's loss and logits. An added
hybrid architecture needs new files only, and an unknown one names the
file to add.
"""
import copy
import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import bench, yardstick
from portbench.drivers import serve
from portbench.drivers.common import port_config
from portbench.reference import lm, weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED = 2**31 + 101


def _conf(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


GRANITE = {"layers": 10, "d": 4096, "vocab": 49155, "eps": 1e-05, "heads": 32, "kv_heads": 8,
           "head_dim": 128, "d_ff": 12800, "rope_theta": 10000.0}
GRANITE_PORT = {"num_heads": 32, "num_kv_heads": 8, "head_dim": 128, "d_ff": 12800,
                "rope_theta": 10000.0}
PARENT = {
    "granite-3-8b": {
        "sizes": {"kind": "attn", **GRANITE},
        "port": GRANITE_PORT,
        "spec": "72bf53ac6e4a243459c2fd424123a363fc74703524d5dbf5eea2f164f080f4da",
        "matmul": 2193633280, "mixer_4k": 1374389534720.0,
    },
    "mamba2-2.7b": {
        "sizes": {"kind": "mamba", "layers": 64, "d": 2560, "vocab": 50280, "eps": 1e-05,
                  "state": 128, "head_dim": 64, "expand": 2, "groups": 1, "conv": 4,
                  "chunk": 256, "a_range": (1, 16), "dt_range": (0.001, 0.1),
                  "dt_floor": 0.0001},
        "port": {"ssm_state": 128, "ssm_head_dim": 64, "ssm_expand": 2, "ssm_groups": 1,
                 "ssm_conv_width": 4, "ssm_chunk": 256},
        "spec": "f8a724dae099f47d2076c171a59890c58fab6f0bad7804c523d75cee76ec451b",
        "matmul": 2700349440, "mixer_4k": 1722013450240,
    },
    "granite-3-8b-40l": {
        "sizes": {"kind": "attn", **GRANITE, "layers": 40},
        "port": GRANITE_PORT,
        "spec": "eacaf1dd2a5b6db3cae3e59d70247029eeb6e1e527fd6226ee4190e37c9e52e0",
        "matmul": 8170516480, "mixer_4k": 5497558138880.0,
    },
}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_sizes_spec_port_and_counts_equal_the_parents(name):
    from repro_torch.configs.base import get_config

    want, conf = PARENT[name], _conf(name)
    sz = weights.sizes(conf)
    assert {k: v for k, v in sz.items() if k != "arch"} == want["sizes"]
    assert Path(sz["arch"].__file__) == HERE / "reference" / "arch" / f"{conf['architecture']}.py"
    assert hashlib.sha256(repr(weights.spec(sz)).encode()).hexdigest() == want["spec"]
    fields = {"num_layers": sz["layers"], "d_model": sz["d"], "vocab_size": sz["vocab"],
              "norm_eps": sz["eps"], **want["port"]}
    assert port_config(conf, sz) == dataclasses.replace(get_config(conf["port_arch"]), **fields)
    assert yardstick.matmul_params(sz) == want["matmul"]
    assert sz["arch"].mixer_flops_forward(sz, 4096) == want["mixer_4k"]


def test_serve_counts_equal_the_parents():
    tr = json.loads((HERE / "traffic" / "serve-rag.json").read_text())
    sz = weights.sizes(_conf("granite-3-8b-40l"))
    assert serve.flops_per_batch(sz, tr) == 1158887537377280.0
    assert serve.decode_bytes_per_batch(sz, tr) == 1354424647680.0


def _small(arch: str) -> dict:
    """A 2-layer configuration of ``arch`` at widths the CPU holds."""
    if arch == "granite":
        conf = _conf("granite-3-8b")
        conf.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                    num_key_value_heads=2, num_hidden_layers=2, vocab_size=300)
    else:
        conf = _conf("mamba2-2.7b")
        conf.update(d_model=64, n_layer=2, vocab_size=300)
        conf["assumed"] = dict(conf["assumed"], d_state=16, headdim=16, chunk_size=16)
    return conf


SMALL = {
    "granite": {
        "loss_f32": 5.735315322875977, "loss_fp8": 5.734327793121338,
        "logits": [-77.29473476241401, 26.720103517177943, -0.22024931013584137,
                   -0.16663695871829987, -0.11891737580299377, -0.026973890140652657],
        "leaves": {
            "blocks/sub0/attn/norm": "1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0",
            "blocks/sub0/attn/wk": "ae048c7f0d3c104d4a1ada2781190712462331229e08b2ea1c46b75385d9d115",
            "blocks/sub0/attn/wo": "855a05bbbc0760e26e511c4be979f52cbd8746fa678e25c042b165f2cdcc03f4",
            "blocks/sub0/attn/wq": "471491204d81a08b46ef637a129b08d07f393fcec816d20254a6995f00b6bf57",
            "blocks/sub0/attn/wv": "3782bb1d331f842c7227af20a23b867f870b658486aa1181df8b3732e5fab648",
            "blocks/sub0/mlp/norm": "1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0",
            "blocks/sub0/mlp/wi_gate": "7b8f45368963f01279f53746b5b90997b96629c76ec45d44b62a5e315e2fdd82",
            "blocks/sub0/mlp/wi_up": "06d440e74b617727d1a6b40609177b1d6a8e94d340ebccb9a37bf1d5c13d0044",
            "blocks/sub0/mlp/wo": "e92c37001dd082e2ada2032c5ddf85a7796dbbcee6bbf5187e5f55f0560662ad",
            "embed/tok": "26ee0be978b7c1a99fb7d788e737319c0bac0b931d25573c899ff70ea5fa91d8",
            "final_norm": "e72710531b01d91ee76a2457cdc9c6c89a197db47da8ebd4ae672e13ddd668cd",
            "head/w": "0f9d4c3aaf77ae7ef1c8f8c9b267af3bedb573599d4f440a82af8b13631496e6",
        },
    },
    "mamba2": {
        "loss_f32": 5.7339653968811035, "loss_fp8": 5.734266757965088,
        "logits": [-49.156622619173504, 27.18335847005359, -0.17920495569705963,
                   -0.17742295563220978, -0.0884571298956871, 0.029930872842669487],
        "leaves": {
            "blocks/sub0/mamba/a_log": "634af02e47727a845e3ca343357bc83731c93f61425a10e763f8be4d4b6b6bf2",
            "blocks/sub0/mamba/conv_bc": "e74553683910b92ac78b3051cde9ca41bdb00e35c75f191a36294754c783f8ed",
            "blocks/sub0/mamba/conv_x": "e55881fc7fbc3d66793f3b03368f4ec90843aaecaeab9d22aa8d27a822625556",
            "blocks/sub0/mamba/d_skip": "a214ae5c03e0c56b5540a2f2e924a30f3a059d4d38c2b8c62b9182a78e8afb24",
            "blocks/sub0/mamba/dt_bias": "d1a70ac8183a7dae6507e6c9ced958f08e15e17e02f0265a0a2318a13f0b56eb",
            "blocks/sub0/mamba/norm": "1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0",
            "blocks/sub0/mamba/out_norm": "8e6b548203bfc0860b22f197dbde1c838d15e2654555143cb6dfa88e0e2bcac2",
            "blocks/sub0/mamba/w_bc": "5de370ab637f978dbb4336678df778d3682fce0a3f8454f338fe3cdf240c7dce",
            "blocks/sub0/mamba/w_dt": "3f2dcab90b74d74f2f65fa483faae79991a2f6ace791f86215ce7ae1dd220012",
            "blocks/sub0/mamba/w_out": "e74e1a2e3588cc38d2eac36ad451f2c0da7d4262de258054ea45859b79feac5c",
            "blocks/sub0/mamba/w_x": "922992b3dc6b3a3c3948b4bba0530ec7486c8a1c734bc410b12db48a3e2a9145",
            "blocks/sub0/mamba/w_z": "ce2cf105c90c389c6d27ffe82a5e943eeffec4531cc19adca12747ebc349c288",
            "embed/tok": "e2f73ffb4ce814e7cbe0bba1a7e2f786278553445507557b562bfd1a8d730c1a",
            "final_norm": "e72710531b01d91ee76a2457cdc9c6c89a197db47da8ebd4ae672e13ddd668cd",
            "head/w": "33b029000fb1544a2c3c1abaf1188d4d430cfda4aa5572d9ef5c884b59364d8c",
        },
    },
}


@pytest.mark.parametrize("arch", sorted(SMALL))
def test_weights_loss_and_logits_equal_the_parents(arch):
    """Every leaf bit for bit; the float32 and fp8 losses of a (2, 48)
    batch and the float32 logits' sum, norm and first four of the last row
    within 1e-6 relative."""
    want = SMALL[arch]
    sz = weights.sizes(_small(arch))
    digests = {p: hashlib.sha256(t.view(torch.int16).numpy().tobytes()).hexdigest()
               for p, t in weights.draw(sz, SEED, "cpu")}
    assert digests == want["leaves"]
    params = weights.make(sz, SEED, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, sz["vocab"], (2, 48), generator=gen)
    labels = torch.randint(0, sz["vocab"], (2, 48), generator=gen)
    w = {k: v.float() for k, v in params.items()}
    for prec in ("f32", "fp8"):
        assert float(lm.loss(w, toks, labels, sz, lm.Precision(prec))) == pytest.approx(
            want[f"loss_{prec}"], rel=1e-6)
    lg = lm.logits(params, toks, sz, lm.Precision("f32")).double()
    got = [float(lg.sum()), float(lg.norm()), *map(float, lg[1, -1, :4])]
    assert got == pytest.approx(want["logits"], rel=1e-6)


TOY = '''"""A toy hybrid: a period of a Mamba2 block without MLP, then a decoder
block with its MLP, each sub-layer with the sizes of its own kind."""
from portbench.reference.arch import granite, mamba2


def sizes(conf):
    attn = granite.sizes(conf)
    ssm = mamba2.sizes({"n_layer": conf["num_hidden_layers"], "d_model": conf["hidden_size"],
                        "vocab_size": conf["vocab_size"], "assumed": conf["assumed"]})
    return {**attn, "kind": "hybrid", "attn": attn, "mamba": ssm}


def period(sz):
    return [mamba2.period(sz["mamba"])[0], granite.period(sz["attn"])[0]]


INITS = {name: (lambda f: lambda shape, sz, gen, device: f(shape, sz["mamba"], gen, device))(f)
         for name, f in mamba2.INITS.items()}


def blocks(sz):
    return [lambda x, p, sz, prec: mamba2.mamba_block(x, p, sz["mamba"], prec),
            lambda x, p, sz, prec: granite.attn_block(x, p, sz["attn"], prec)]


def _per_period(sz):
    n = sz["layers"] // 2
    return dict(sz["mamba"], layers=n), dict(sz["attn"], layers=n)


def matmul_params(sz):
    ssm, attn = _per_period(sz)
    return mamba2.matmul_params(ssm) + granite.matmul_params(attn)


def mixer_flops_forward(sz, seq_len):
    ssm, attn = _per_period(sz)
    return mamba2.mixer_flops_forward(ssm, seq_len) + granite.mixer_flops_forward(attn, seq_len)


def port_fields(sz):
    return {**mamba2.port_fields(sz["mamba"]), **granite.port_fields(sz["attn"]),
            "period": (("mamba", None), ("attn", "mlp"))}


def state_reset(sz):
    return mamba2.state_reset(sz["mamba"])
'''


def test_an_added_hybrid_architecture_needs_no_edit(tmp_path):
    """In a copy of the tree, a hybrid of the two architectures' blocks
    enters as added files and entries: the cell resolves, the spec's leaves
    are the port's, path for path and shape for shape (the check the
    training driver makes on the card), and the reference's loss gives a
    gradient on every leaf of both sub-layers."""
    from repro_torch.configs.base import SubLayer
    from repro_torch.models.model import param_shapes
    from repro_torch.optim import adamw

    pb = tmp_path / "portbench"
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns("__pycache__"))
    b = bench.benchmark()
    (pb / "reference" / "arch" / "toy-hybrid.py").write_text(TOY)
    conf = _small("granite")
    conf.update(architecture="toy-hybrid", num_hidden_layers=4,
                assumed=_small("mamba2")["assumed"])
    (pb / "configs" / "toy-hybrid.json").write_text(json.dumps(conf))
    traffic = json.loads((HERE / "traffic" / "train-4k.json").read_text())
    traffic["seq_len"] = 32
    (pb / "traffic" / "train-toy.json").write_text(json.dumps(traffic))
    name = "toy-hybrid.train-toy"
    (pb / "cells" / f"{name}.json").write_text(json.dumps({"limits": {"loss_gap": 1e-3}}))
    b["configs"].append({"name": "toy-hybrid", "source": "x", "reduced": [], "why": "x",
                         "file": "portbench/configs/toy-hybrid.json"})
    b["workloads"].append({"name": name, "config": "toy-hybrid", "traffic": "train-toy",
                           "chips": 1, "why": "x"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "granite-3-8b.train-4k" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    c = bench.cell(name, root=tmp_path)
    assert c.root == tmp_path and c.traffic["seq_len"] == 32
    assert {m["name"] for m in c.per_layer} >= {"mfu.train", "idle_pct.train"}
    sz = weights.sizes(c.config, c.root)
    assert Path(sz["arch"].__file__) == pb / "reference" / "arch" / "toy-hybrid.py"
    arch = port_config(c.config, sz)
    assert arch.period == (SubLayer("mamba", None), SubLayer("attn", "mlp"))
    want = {p: tuple(t.shape) for p, t in adamw.leaves(param_shapes(arch))}
    assert {p: shape for p, shape, _, _ in weights.spec(sz)} == want
    assert yardstick.train_step_flops(sz, 32, 2) > 0

    w = {k: v.float().requires_grad_(True) for k, v in weights.make(sz, SEED, "cpu").items()}
    gen = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, sz["vocab"], (2, 32), generator=gen)
    loss = lm.loss(w, toks, toks.roll(-1, dims=1), sz, lm.Precision("f32"))
    assert torch.isfinite(loss)
    blocks = sorted(k for k in w if k.startswith("blocks/"))
    assert {k.split("/")[1] for k in blocks} == {"sub0", "sub1"}
    for k, g in zip(blocks, torch.autograd.grad(loss, [w[k] for k in blocks])):
        assert torch.isfinite(g).all() and g.abs().sum() > 0, k


def test_an_unknown_architecture_names_the_file_to_add():
    conf = copy.deepcopy(_conf("granite-3-8b"))
    conf["architecture"] = "granite-5"
    with pytest.raises(ValueError, match="add portbench/reference/arch/granite-5.py"):
        weights.sizes(conf)
