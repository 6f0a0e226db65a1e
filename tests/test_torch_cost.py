"""The port's counted cost model (``repro_torch.utils.cost``) against the
reference's compiler-derived one (``repro.utils.hlo``), on the CPU.

* One device: the counted FLOPs of every smoke config's training step
  (B 2, S 32) and of stablelm-1.6b's train, prefill and decode steps (B 8,
  S 64), on meta tensors, EQUAL ``hlo.analyze`` of the reference's
  compiled steps.
* Small meshes: the reference's own ``dryrun_pair`` in one subprocess with
  8 host devices, its production mesh patched to (2, 2) and (2, 2, 2)
  ``AxisType.Auto`` meshes (``jax.make_mesh``'s default ``Explicit`` axes
  make its ``constrain`` raise), smoke stablelm-1.6b at B 8, S 64, against
  the port's ``dryrun_pair`` on the same logical meshes: train and prefill
  FLOPs per device equal, decode within 30 % (the reference's decode
  record takes XLA's own count, which also counts elementwise ops, where
  it is larger than the dot count), and the intra- and cross-pod link bytes
  each within a factor of 2 and zero where the reference's are.
* ``CollectiveOp``'s ring link bytes and the cross-pod rule against the
  reference's on the same fields.
* The loops the meta count folds (microbatches, clouds, the sLSTM's token
  loops): the meta count equals the same step walked whole on CPU tensors.
* The bytes rules and ``temp_bytes`` on hand-computed cases, a kernel
  entry point counted as one unit with the bytes it writes in place, and
  an op with no placement rule recorded.
* The CLI's records carry the reference's keys with the compiler half
  filled.

``PYTHONPATH=src:. python tests/test_torch_cost.py`` prints the small-mesh
table (FLOPs, bytes and link bytes of both, and their ratios)."""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.launch import specs as rspecs
from repro.launch import steps as rsteps
from repro.models import build_model as ref_build_model
from repro.utils import hlo
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import specs as pspecs
from repro_torch.utils import cost

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {False: (("data", "model"), (2, 2)), True: (("pod", "data", "model"), (2, 2, 2))}
KINDS = ("training", "prefill", "decode")

# the reference's dryrun_pair on (2, 2) and (2, 2, 2) meshes of 8 host
# devices; jax is initialised with 8 devices before repro.launch.dryrun
# (which asks for 512 at import) is imported
_SUBPROCESS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
assert len(jax.devices()) == 8
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import dryrun, mesh as rmesh
MESHES = {False: (("data", "model"), (2, 2)), True: (("pod", "data", "model"), (2, 2, 2))}
dryrun.get_config = get_smoke_config
dryrun.get_shape = lambda name: ShapeConfig(name, 64, 8, name)
out = {}
for kind in ("training", "prefill", "decode"):
    for mp in (False, True):
        axes, sizes = MESHES[mp]
        rmesh.make_production_mesh = lambda multi_pod=False, a=axes, s=sizes: jax.make_mesh(
            s, a, axis_types=(AxisType.Auto,) * len(a))
        rec = dryrun.dryrun_pair("stablelm-1.6b", kind, multi_pod=mp, verbose=False)
        r = rec["roofline"]
        out[f"{kind}|{int(mp)}"] = {
            "flops": rec["hlo_flops_per_device"], "bytes": rec["hlo_bytes_per_device"],
            "ici": r["ici_link_bytes"], "dcn": r["dcn_link_bytes"],
            "by_kind": r["collectives_by_kind"]}
json.dump(out, sys.stdout)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start_reference():
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", _ROOT),
           "PYTHONPATH": os.path.join(_ROOT, "src")}
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", _SUBPROCESS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, text=True)


@pytest.fixture(autouse=True, scope="module")
def ref_small_meshes():
    """The reference's six small-mesh records: its subprocess starts with the
    module, so that it runs beside the one-device tests, and is read when a
    test needs them."""
    proc = _start_reference()
    cache = {}

    def get():
        if not cache:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            cache.update(json.loads(out))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ------------------------------------------------------------- one device
def _ref_flops(arch: str, kind: str, b: int, s: int) -> float:
    """hlo.analyze FLOPs of the reference's compiled step, one device."""
    cfg = ref_smoke_config(arch)
    model = ref_build_model(cfg)
    shape = RefShapeConfig(kind, s, b, kind)
    params, opt = rspecs.state_specs(model)
    if kind == "training":
        step = rsteps.make_train_step(model, RefTrainConfig(seq_len=s, global_batch=b))
        lowered = jax.jit(step).lower(params, opt, rspecs.train_batch_specs(cfg, shape))
    elif kind == "prefill":
        batch = rspecs.train_batch_specs(cfg, shape)
        batch.pop("labels")
        lowered = jax.jit(rsteps.make_prefill_step(model, shape)).lower(params, batch)
    else:
        window = rsteps.decode_window_for(cfg, shape)
        lowered = jax.jit(rsteps.make_decode_step(model, window)).lower(
            params, rspecs.cache_specs(model, cfg, shape, window),
            rspecs.decode_token_specs(shape))
    return hlo.analyze(lowered.compile().as_text()).flops


def _port_cost(arch: str, kind: str, b: int, s: int) -> cost.StepCost:
    """The port's counted cost of the same step, one device, meta tensors."""
    cfg = get_smoke_config(arch)
    return dryrun.step_cost(cfg, ShapeConfig(kind, s, b, kind), None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_flops_equal_reference_hlo(arch):
    assert _port_cost(arch, "training", 2, 32).flops == _ref_flops(arch, "training", 2, 32)


@pytest.mark.parametrize("kind,want", [("training", 1_535_115_264), ("prefill", 445_644_800),
                                       ("decode", 7_995_392)])
def test_stablelm_steps_flops_equal_reference_hlo(kind, want):
    got = _port_cost("stablelm-1.6b", kind, 8, 64).flops
    assert got == _ref_flops("stablelm-1.6b", kind, 8, 64) == want


# The loops the meta count folds (``cost.scan_range``): microbatches,
# clouds, the sLSTM's token loops, against the same step walked whole on
# real CPU tensors (the dry run's own step builders, their meta tensors made
# real): (arch, kind, batch, seq, microbatches, mesh sizes (pod, data, model)
# or None for one device).
_WALKS = {
    "microbatches-2": ("stablelm-1.6b", "training", 8, 32, 2, None),
    "microbatches-4": ("stablelm-1.6b", "training", 8, 32, 4, None),
    "clouds-2": ("stablelm-1.6b", "training", 4, 32, 1, (2, 2, 2)),
    "clouds-4": ("stablelm-1.6b", "training", 8, 32, 2, (4, 1, 1)),
    "xlstm-train": ("xlstm-125m", "training", 2, 16, 1, None),
    "xlstm-prefill": ("xlstm-125m", "prefill", 2, 16, 1, None),
}


@pytest.mark.parametrize("case", list(_WALKS))
def test_meta_count_equals_the_walked_count(case, monkeypatch):
    arch, kind, b, s, mb, pods = _WALKS[case]
    cfg = get_smoke_config(arch)
    shape = ShapeConfig(kind, s, b, kind)
    mesh = (pmesh.LogicalMesh(("pod", "data", "model"), pods) if pods else
            pmesh.LogicalMesh(("data", "model"), (1, 1)))
    meta = dryrun._count(cfg, shape, mesh, mb, pods is not None)
    monkeypatch.setattr(pspecs, "META", torch.device("cpu"))
    monkeypatch.setattr(pspecs, "meta", lambda shp, dtype: torch.zeros(tuple(shp), dtype=dtype))
    real = dryrun._count(cfg, shape, mesh, mb, pods is not None)
    for field in ("flops", "hbm_bytes", "temp_bytes"):
        assert getattr(meta, field) == pytest.approx(getattr(real, field), rel=1e-12), field
    assert meta.link_bytes() == pytest.approx(real.link_bytes(), rel=1e-12)
    assert meta.n_collectives() == real.n_collectives()
    assert not meta.unruled and not real.unruled


# ------------------------------------------------------------ small meshes
def _port_record(kind: str, mp: bool, patch) -> dict:
    """The port's ``dryrun_pair`` as the reference's is driven: its config,
    shape and production mesh patched to the smoke config, B 8 × S 64 and a
    small logical mesh."""
    axes, sizes = MESHES[mp]
    patch(dryrun, "get_config", get_smoke_config)
    patch(dryrun, "get_shape", lambda name: ShapeConfig(name, 64, 8, name))
    patch(pmesh, "make_production_mesh", lambda multi_pod=False: pmesh.LogicalMesh(axes, sizes))
    return dryrun.dryrun_pair("stablelm-1.6b", kind, multi_pod=mp)


@pytest.mark.parametrize("mp", [False, True], ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("kind", KINDS)
def test_small_mesh_records_hold_against_reference(ref_small_meshes, monkeypatch, kind, mp):
    rec = _port_record(kind, mp, monkeypatch.setattr)
    ref = ref_small_meshes()[f"{kind}|{int(mp)}"]
    flops = rec["hlo_flops_per_device"]
    if kind == "decode":
        assert abs(flops / ref["flops"] - 1) <= 0.30, (flops, ref["flops"])
    else:
        assert flops == ref["flops"]
    for key, mine in (("ici", rec["roofline"]["ici_link_bytes"]),
                      ("dcn", rec["roofline"]["dcn_link_bytes"])):
        if ref[key] == 0:
            assert mine == 0, (key, mine)
        else:
            assert 0.5 <= mine / ref[key] <= 2.0, (key, mine, ref[key])
    # per device: a 2 x 2 x 2 record splits the 2 x 2 record's work over the pods
    assert rec["devices"] == (8 if mp else 4)


# -------------------------------------------------------------- collectives
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [1, 2, 4, 16])
def test_collective_link_bytes_match_reference(kind, group):
    fields = dict(kind=kind, operand_bytes=12_288, output_bytes=49_152, group_size=group,
                  num_groups=8 // min(group, 8), cross_pod=False, count=3.0)
    ref = hlo.CollectiveOp(**fields, line="")
    assert cost.CollectiveOp(**fields).link_bytes_per_device == ref.link_bytes_per_device


@pytest.mark.parametrize("axes", [("data",), ("model",), ("pod",), ("pod", "data"),
                                  ("data", "model"), ("pod", "data", "model")])
def test_cross_pod_rule_matches_reference(axes):
    shape = {"pod": 2, "data": 2, "model": 2}
    groups = cost.replica_groups(shape, axes)
    assert sorted(d for g in groups for d in g) == list(range(8))
    assert all(len(g) == 2 ** len(axes) for g in groups)
    for pod_size in (0, 2, 4, 8):
        assert cost.groups_cross_pod(groups, pod_size) == hlo._groups_cross_pod(groups,
                                                                                pod_size)
    assert cost.groups_cross_pod(groups, 4) == ("pod" in axes)


# ---------------------------------------------------------------- the rules
def _f32(*shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0))


def test_matmul_counts_its_operands_output_and_dot():
    a, b = _f32(4, 8), _f32(8, 16)
    c = cost.count_step(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * 4 * 16 * 8
    assert c.hbm_bytes == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    assert c.temp_bytes == 4 * 4 * 16 and not c.collectives


def test_views_count_nothing():
    x = _f32(4, 6, 8)
    c = cost.count_step(lambda t: t.view(24, 8).t().unsqueeze(0).transpose(1, 2)[0, 3:],
                        x)
    assert c.flops == 0 and c.hbm_bytes == 0 and c.temp_bytes == 0


def test_index_copy_counts_the_region_written():
    buf, src = _f32(100, 8), _f32(3, 8)
    idx = torch.tensor([5, 17, 42])
    c = cost.count_step(lambda b, i, s: b.index_copy_(0, i, s), buf, idx, src)
    assert c.hbm_bytes == 2 * 3 * 8 * 4 + 3 * 8      # the slice read and written, the index
    assert c.temp_bytes == 0                          # in place


def test_cast_counts_and_temp_bytes_is_the_peak():
    x = _f32(64, 64)

    def step(t):
        y = t.to(torch.bfloat16)          # 8 KiB
        z = y.float() * 2                 # 16 KiB + 16 KiB, y freed after
        del y
        return z.sum()

    c = cost.count_step(step, x)
    n = 64 * 64
    assert c.hbm_bytes == (4 * n + 2 * n) + (2 * n + 4 * n) + (4 * n + 4 * n) + (4 * n + 4)
    assert c.temp_bytes == 2 * n + 4 * n + 4 * n     # y, y.float() and the product live


def test_kernel_entry_point_counts_as_one_unit():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 16, 2, 2, 32), generator=g)
    k = torch.randn((2, 16, 2, 32), generator=g)
    v = torch.randn((2, 16, 2, 32), generator=g)
    c = cost.count_step(lambda q, k, v: ops.flash_prefill_attention(q, k, v), q, k, v)
    assert c.flops == 2 * (2 * 2 * 2 * 2 * 16 * 16 * 32)      # QK^T and PV, 2·M·N·K each
    assert c.hbm_bytes == 4 * (q.numel() + k.numel() + v.numel() + q.numel())
    c = cost.count_step(ops.sq_norm, q)
    assert c.flops == 0 and c.hbm_bytes == 4 * q.numel() + 4


def test_kernel_unit_counts_the_bytes_it_writes_in_place():
    g = torch.Generator().manual_seed(0)
    kv = torch.randn((3, 1, 2, 32), generator=g)      # a decode step's k/v, 3 rows
    pool = {"k": torch.zeros((4, 8, 2, 32), dtype=torch.int8),
            "v": torch.zeros((4, 8, 2, 32), dtype=torch.int8),
            "ks": torch.zeros((4, 8, 2)), "vs": torch.zeros((4, 8, 2))}
    table, starts = torch.tensor([[0, 1], [2, 3], [1, 0]]), torch.tensor([3, 9, 0])
    c = cost.count_step(lambda *a: ops.kv_write_int8(pool, *a), kv, kv, table, starts)
    inputs = 2 * 4 * kv.numel() + 8 * (table.numel() + starts.numel())
    written = 2 * kv.numel() * (1 + 4 / 32)           # int8 k and v, an fp32 scale a head
    assert c.hbm_bytes == inputs + written and c.temp_bytes == 0


def test_an_op_with_no_placement_rule_is_recorded():
    mesh = pmesh.LogicalMesh(("data", "model"), (2, 2))
    x = torch.empty((8, 16), device="meta")
    c = cost.count_step(lambda t: torch.roll(t, 1, 0), x, mesh=mesh, specs=(("data", None),))
    assert c.unruled == {"roll": 1}
    c = cost.count_step(lambda t: torch.exp(t) * 2, x, mesh=mesh, specs=(("data", None),))
    assert not c.unruled


def test_split_contraction_is_an_all_reduce():
    mesh = pmesh.LogicalMesh(("data", "model"), (2, 4))
    x, w = torch.empty((8, 64), device="meta"), torch.empty((64, 32), device="meta")
    c = cost.count_step(lambda x, w: x @ w, x, w, mesh=mesh,
                        specs=(("data", "model"), ("model", None)))
    assert c.flops == 2 * 8 * 32 * 64 / 8
    (op,) = c.collectives
    assert (op.kind, op.group_size, op.num_groups, op.cross_pod) == ("all-reduce", 4, 2, False)
    assert op.operand_bytes == 8 * 32 * 4 / 2          # the output's rows on one device


def test_federated_sum_is_cross_pod():
    mesh = pmesh.LogicalMesh(("pod", "data", "model"), (2, 2, 2))
    a, b = torch.empty((16, 8), device="meta"), torch.empty((16, 8), device="meta")
    c = cost.count_step(lambda a, b: (a + b) * 2, a, b, mesh=mesh,
                        specs=(cost.Owned("pod", 0, ("model", None)),
                               cost.Owned("pod", 1, ("model", None))))
    (op,) = c.collectives
    assert op.kind == "all-reduce" and op.cross_pod and op.operand_bytes == 16 * 8 * 4 / 2


# --------------------------------------------------------------- the CLI
def test_cli_records_fill_the_compiler_half(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k,long_500k",
                 "--multi-pod", "both", "--workers", "1", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 4 and "all dry-runs passed" in capsys.readouterr().out
    for r in recs:
        for k in ("hlo_flops_per_device", "hlo_bytes_per_device", "model_flops_total",
                  "model_flops_per_device", "useful_flops_ratio", "memory", "roofline",
                  "dominant", "compile_seconds", "devices"):
            assert k in r, k
        assert r["hlo_flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
        assert 0 < r["useful_flops_ratio"] <= 1.0
        assert r["memory"]["temp_bytes"] > 0 and r["memory"]["code_bytes"] is None
        rf = r["roofline"]
        for k in ("compute_s", "memory_s", "collective_s", "ici_link_bytes", "dcn_link_bytes",
                  "n_collectives"):
            assert rf[k] is not None and rf[k] >= 0, k
        assert rf["xla_reported_flops"] is None and rf["xla_reported_bytes"] is None
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["compile_seconds"] is None and r["needs"] == list(dryrun.COMPILER_ONLY)
        assert rf["compute_s"] == r["hlo_flops_per_device"] / pmesh.PEAK_FLOPS


def _table():
    """The small-mesh table: the reference's records beside the port's."""
    proc = _start_reference()
    ours = {f"{k}|{int(mp)}": _port_record(k, mp, setattr) for k in KINDS for mp in (False, True)}
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads(out)
    print("record | FLOPs/device port (ref) | HBM bytes port / ref | ici B port (ref) | "
          "dcn B port (ref)")
    for key, r in ours.items():
        kind, mp = key.split("|")
        rf, x = r["roofline"], ref[key]
        print(f"{kind} {'2x2x2' if mp == '1' else '2x2'} | {r['hlo_flops_per_device']:.0f} "
              f"({x['flops']:.0f}) | {r['hlo_bytes_per_device']:.0f} / {x['bytes']:.0f} = "
              f"{r['hlo_bytes_per_device'] / x['bytes']:.3f} | {rf['ici_link_bytes']:.0f} "
              f"({x['ici']:.0f}) | {rf['dcn_link_bytes']:.0f} ({x['dcn']:.0f})")


if __name__ == "__main__":
    torch.set_num_threads(1)
    _table()
