"""The port's simulator reduction (``repro_torch.kernels.cell_reduce`` and
the ``TrainingSimulator`` reduction registry) held against the JAX package.

* The plain float32 version vs the Pallas ``cell_reduce`` in interpret mode
  at (2,2,2), (4,8,4) and (8,8,16) (rtol 1e-6).
* The float64 version vs the JAX package's nested-loop oracle
  ``iteration_time_reference()`` on a faulted simulator (rtol 1e-12).
* The port's ``TrainingSimulator`` on its ``torch`` reduction vs the JAX
  package's simulator, across the read API and a run of fault events.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.simulator import JobSpec as RefJobSpec
from repro.cluster.simulator import TrainingSimulator as RefSim
from repro.cluster.spec import ClusterSpec as RefClusterSpec
from repro.cluster.spec import ModelSpec as RefModelSpec
from repro.kernels import cell_reduce as ref_ck
from repro_torch.cluster import simulator as S
from repro_torch.cluster.spec import ClusterSpec, ModelSpec
from repro_torch.kernels import cell_reduce as ck

CONSTS = (3.0, 2.0, 0.7, 1.3, 0.9)   # c_flops, c_speed, c_tp, pp_vol, c_dp


def _inputs(pp, dp, tp, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(0.5, 1.0, (pp, dp)),
        rng.uniform(5.0, 40.0, (pp, dp, tp)),
        rng.uniform(5.0, 40.0, (pp, dp, tp)),
        rng.uniform(5.0, 40.0, (pp - 1, dp)),
        rng.uniform(1.0, 3.0, (dp,)),
    )


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 8, 4), (8, 8, 16)])
def test_plain_float32_matches_jax_interpret(shape):
    pp, dp, tp = shape
    arrays = _inputs(pp, dp, tp, seed=sum(shape))
    want = ref_ck.cell_reduce(
        *(jnp.asarray(a, jnp.float32) for a in arrays), *CONSTS,
        interpret=True,
    )
    got = ck.cell_reduce_reference(
        *(torch.as_tensor(a, dtype=torch.float32) for a in arrays), *CONSTS
    )
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    arrays = [torch.as_tensor(a) for a in _inputs(3, 5, 4, seed=1)]
    before = ck.cell_reduce.launches
    got = ck.cell_reduce(*arrays, *CONSTS)
    want = ck.cell_reduce_reference(*arrays, *CONSTS)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert ck.cell_reduce.launches == before


def _model(pkg_model_spec):
    return pkg_model_spec(layers=16, hidden=2048, seq_len=1024, vocab=32000)


def _faulted_pair(tp=4, dp=8, pp=4, seed=0):
    """The same faulted job in both packages: the JAX package's simulator
    and the port's, on its float64 ``torch`` reduction on the CPU."""
    n = tp * dp * pp
    ref = RefSim(cluster=RefClusterSpec(n_nodes=n // 8),
                 job=RefJobSpec(model=_model(RefModelSpec), tp=tp, dp=dp,
                                pp=pp, micro_batches=2 * dp))
    port = S.TrainingSimulator(
        cluster=ClusterSpec(n_nodes=n // 8),
        job=S.JobSpec(model=_model(ModelSpec), tp=tp, dp=dp, pp=pp,
                      micro_batches=2 * dp),
        reduction="torch", device="cpu",
    )
    rng = np.random.default_rng(seed)
    for d in rng.choice(n, 5, replace=False):
        ref.state.devices[int(d)].compute_speed = 0.7
        port.state.devices[int(d)].compute_speed = 0.7
    node = int(rng.integers(n // 8))
    ref.state.degrade_nic(node, 0.5)
    port.state.degrade_nic(node, 0.5)
    return ref, port


def test_plain_float64_matches_reference_loop_oracle():
    """The float64 plain version on the port's measured cells vs the JAX
    package's nested-loop ``iteration_time_reference()``."""
    ref, port = _faulted_pair()
    c = port._cells()
    t, stage_max, tp_bw, dp_bw = ck.cell_reduce_reference(
        *(torch.as_tensor(a) for a in (c.cell_speed, c.tp_edge, c.dp_edge,
                                       c.hop_bw, port._alloc_off())),
        c.c_flops, c.c_speed, c.c_tp, c.pp_vol, c.c_dp,
    )
    np.testing.assert_allclose(float(t), ref.iteration_time_reference(),
                               rtol=1e-12)
    np.testing.assert_allclose(stage_max[0].numpy(),
                               ref.per_microbatch_times_reference(), rtol=1e-12)


@pytest.mark.parametrize("name", ["reference", "vectorized", "torch", "cuda"])
def test_reduction_backends_match_reference_package(name):
    """Every port reduction backend vs the JAX package's loop oracles, within
    the backend's own tolerance (``cuda`` on a CPU device runs the plain
    float32 version)."""
    ref, port = _faulted_pair(seed=3)
    rb = S.select_reduction_backend(name, device="cpu")
    tol = max(rb.tolerance, 1e-12)
    np.testing.assert_allclose(rb.iteration_time(port),
                               ref.iteration_time_reference(), rtol=tol)
    np.testing.assert_allclose(rb.per_microbatch_times(port),
                               ref.per_microbatch_times_reference(), rtol=tol)
    want = ref.profile_groups_reference()
    got = rb.profile_groups(port)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)


def test_simulator_tracks_reference_through_fault_events():
    """The port's simulator on its torch reduction follows the JAX
    package's through device, link and NIC events and a remap, and
    copies the cells once per memo key."""
    ref, port = _faulted_pair(seed=5)
    rb = port._reduction_backend()
    assert isinstance(rb, S.TorchReduction) and rb.device.type == "cpu"
    rng = np.random.default_rng(9)
    n = port.job.n_devices
    for step in range(12):
        d = int(rng.integers(n))
        v = float(rng.uniform(0.3, 1.0))
        for sim in (ref, port):
            sim.state.devices[d].compute_speed = v
        if step % 4 == 1:
            a, b = int(rng.integers(n)), int(rng.integers(n))
            for sim in (ref, port):
                sim.state.degrade_link(a, b, 0.6)
        np.testing.assert_allclose(port.iteration_time(), ref.iteration_time(),
                                   rtol=1e-12)
        copies = rb.copies
        port.per_microbatch_times()   # same memo key: no second copy
        assert rb.copies == copies
    perm = list(range(n))
    perm[0], perm[-1] = perm[-1], perm[0]
    for sim in (ref, port):
        sim.remap_groups(perm)
    np.testing.assert_allclose(port.iteration_time(), ref.iteration_time(),
                               rtol=1e-12)
    assert rb.copies > 10 and rb.copy_bytes > 0


@pytest.mark.parametrize("name,dtype", [("torch", torch.float64),
                                        ("cuda", torch.float32)])
def test_each_reduction_name_has_one_precision(name, dtype):
    """The registry name fixes the precision, as in the reference: the
    plain version runs in float64, the kernel in float32."""
    rb = S.select_reduction_backend(name, device="cpu")
    assert rb.dtype == dtype and rb.device.type == "cpu"


def test_auto_reduction_needs_the_card_or_an_explicit_cpu():
    job = S.JobSpec(model=_model(ModelSpec), tp=2, dp=2, pp=2, micro_batches=4)
    assert isinstance(S.resolve_reduction_backend("auto", device="cpu"),
                      S.TorchReduction)
    assert S.resolve_reduction_backend("vectorized") is None
    with pytest.raises(ValueError, match="unknown reduction backend"):
        S.select_reduction_backend("pallas")
    if not torch.cuda.is_available():
        sim = S.TrainingSimulator(cluster=ClusterSpec(n_nodes=1), job=job)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sim.iteration_time()

