"""The port's §3.1 partitioner (``repro_torch.core.partition``) and §3.2
transport model (``repro_torch.core.protocols``) against the reference's, on
the CPU: numpy and plain-Python copies, so every output is ``==``."""
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import partition as ref_partition
from repro.core import protocols as ref_protocols
from repro_torch.core import partition, protocols

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores (a 100-step smoke run went from seconds to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mod, strategy, granule, nominal, rounds=24, slow_at=12):
    """A partitioner fed back each round's times, one cloud slowed mid-run
    (as the heterogeneous-clouds example does); every output recorded."""
    p = mod.Partitioner(strategy=strategy, n_clouds=len(nominal), granule=granule)
    state = p.init(nominal)
    speeds = np.asarray(nominal, np.float64)
    out = []
    for r in range(rounds):
        if r == slow_at:
            speeds = speeds.copy()
            speeds[1] *= 0.2
        sizes = p.quantize(state, 130)
        state = p.observe(state, sizes, sizes / speeds)
        out.append((sizes.tolist(), state.shares.tolist(), state.ema_throughput.tolist(),
                    state.moved_samples, mod.Partitioner.round_time(sizes, speeds),
                    mod.Partitioner.utilization(sizes, speeds)))
    return out


@pytest.mark.parametrize("granule", [1, 4, 16])
@pytest.mark.parametrize("strategy", ["fixed", "weighted", "dynamic"])
def test_partitioner_equals_reference(strategy, granule):
    for nominal in ([1.0, 2.0, 4.0], [3.0, 1.0, 1.0, 0.5], None):
        args = nominal if nominal is not None else [1.0, 1.0, 1.0]
        assert _run(partition, strategy, granule, args) == \
            _run(ref_partition, strategy, granule, args)
        # init without a nominal throughput, and tied fractional parts
        p, rp = (m.Partitioner(strategy=strategy, n_clouds=3, granule=granule)
                 for m in (partition, ref_partition))
        s, rs = p.init(nominal and nominal[:3]), rp.init(nominal and nominal[:3])
        assert np.array_equal(s.shares, rs.shares) and np.array_equal(s.ema_throughput,
                                                                      rs.ema_throughput)
        for batch in (7, 64, 100, 128):
            assert p.quantize(s, batch).tolist() == rp.quantize(rs, batch).tolist()


def test_partitioner_min_share_and_state_fields():
    assert [f.name for f in dataclasses.fields(partition.PartitionState)] == \
        [f.name for f in dataclasses.fields(ref_partition.PartitionState)]
    assert {f.name: f.default for f in dataclasses.fields(partition.Partitioner)} == \
        {f.name: f.default for f in dataclasses.fields(ref_partition.Partitioner)}
    # a cloud 100x slower keeps about min_share (clamped, then renormalized);
    # sizes never drop below one granule
    outs = []
    for mod in (partition, ref_partition):
        p = mod.Partitioner(strategy="dynamic", n_clouds=3, granule=4)
        st = p.init()
        for _ in range(40):
            sizes = p.quantize(st, 64)
            st = p.observe(st, sizes, sizes / np.array([100.0, 1.0, 100.0]))
        assert p.min_share / (1 + 3 * p.min_share) <= st.shares.min() < p.min_share
        assert sizes.min() >= 4 and sizes.sum() <= 64
        outs.append((st.shares.tolist(), sizes.tolist()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("topology", ["star", "ring"])
@pytest.mark.parametrize("name", ["tcp", "grpc", "quic"])
def test_sync_wall_time_equals_reference(name, topology):
    proto, ref = protocols.PROTOCOLS[name], ref_protocols.PROTOCOLS[name]
    assert dataclasses.astuple(proto) == dataclasses.astuple(ref)
    links = [protocols.Link(), protocols.Link(latency_s=0.08, bandwidth=1.25e8, loss_rate=1e-3)]
    ref_links = [ref_protocols.Link(), ref_protocols.Link(latency_s=0.08, bandwidth=1.25e8,
                                                          loss_rate=1e-3)]
    for link, ref_link in zip(links, ref_links):
        for n_streams in range(1, 17):
            assert proto.efficiency(n_streams) == ref.efficiency(n_streams)
            for nbytes in (1e3, 77_075_040, 6.6e9):
                for reuse in (True, False):
                    assert proto.transfer_time(nbytes, link, n_streams, reuse) == \
                        ref.transfer_time(nbytes, ref_link, n_streams, reuse)
                for n_clouds in (2, 3, 8):
                    assert protocols.sync_wall_time(nbytes, n_clouds, proto, link, n_streams,
                                                    topology) == \
                        ref_protocols.sync_wall_time(nbytes, n_clouds, ref, ref_link, n_streams,
                                                     topology)
    with pytest.raises(ValueError):
        protocols.sync_wall_time(1e6, 2, proto, links[0], topology="mesh")


def test_partitioning_demo_equals_reference_and_example_imports_no_jax():
    spec = importlib.util.spec_from_file_location("ref_hetero",
                                                  ROOT / "examples" / "heterogeneous_clouds.py")
    ref_ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_ex)
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_heterogeneous_clouds as ex
    finally:
        sys.path.remove(str(ROOT / "examples"))
    got, want = ex.partitioning_demo(), ref_ex.partitioning_demo()
    assert got.shares.tolist() == want.shares.tolist()
    assert got.moved_samples == want.moved_samples
    code = (
        "import runpy, sys\n"
        "sys.argv = ['torch_heterogeneous_clouds.py', '--device', 'cpu', '--steps', '2']\n"
        "runpy.run_path('examples/torch_heterogeneous_clouds.py', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "HOME": os.environ.get("HOME", str(pathlib.Path.home())), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert "round 30: shares=" in out and "async  : final loss" in out
