"""The port's secure aggregation (``repro_torch.core.privacy``: ``to_fixed``,
``from_fixed``, ``mask_update``, ``secure_sum``, ``secure_aggregate``)
against the reference's, on the CPU.

The masks are the port's own bits (a ``torch.Generator`` per pair; torch
cannot replay threefry), but they cancel exactly, so ``secure_aggregate``
must equal the reference's bit for bit, also where ``to_fixed`` saturates
(|x| ≥ 32768, ±inf) and on NaN, which XLA's conversion takes to 0."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as ref_privacy
from repro_torch.core import privacy
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
SPECIAL = np.array([1e10, -1e10, np.nan, np.inf, -np.inf, 32767.99, 32768.0, -32768.0,
                    -32768.01, 32767.998046875, 0.5 / 65536, 1.5 / 65536, -0.5 / 65536,
                    -2.5 / 65536], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores (a 100-step smoke run went from seconds to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _updates(n_clouds: int, seed: int) -> list[dict]:
    """Per-cloud updates drawn with numpy (bridged into both packages) in a
    tree of three of the params' leaf paths, ~1e-2 in size, the special
    values planted at the start of ``embed/tok`` of cloud 0 and at the end
    of ``ln_f`` of the last. One shape for every leaf: the reference's
    eager ops compile once per shape."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": {"tok": (48, 40)}, "layers": {"attn": {"wq": (48, 40)}},
              "ln_f": {"scale": (48, 40)}}
    out = []
    for c in range(n_clouds):
        tree = tree_map(lambda sh: (rng.standard_normal(sh) * 1e-2).astype(np.float32), shapes)
        if c == 0:
            tree["embed"]["tok"].reshape(-1)[: len(SPECIAL)] = SPECIAL
        if c == n_clouds - 1:
            tree["ln_f"]["scale"].reshape(-1)[-len(SPECIAL):] = SPECIAL[::-1]
        out.append(tree)
    return out


def _bits(tree) -> list[np.ndarray]:
    return [np.asarray(x).view(np.int32) for x in tree_leaves(tree)]


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("n_clouds", [2, 3, 4])
def test_secure_aggregate_bitwise_reference(n_clouds):
    ups = _updates(n_clouds, n_clouds)
    want = ref_privacy.secure_aggregate([_jax(u) for u in ups], 7)
    got = privacy.secure_aggregate([_torch(u) for u in ups], 7)
    for a, b in zip(_bits(tree_map(lambda x: x.numpy(), got)), _bits(want)):
        np.testing.assert_array_equal(a, b)
    # the saturated and infinite inputs reached the sum (±1e10, +inf: near
    # the ends of the fixed-point range), the NaN as 0
    sat = np.asarray(want["embed"]["tok"]).reshape(-1)
    assert np.abs(sat[[0, 1, 3]]).min() > 32000 and abs(sat[2]) < 1


def test_to_fixed_saturates_as_xla_and_from_fixed_matches():
    x = np.concatenate([SPECIAL, np.linspace(-40000, 40000, 1001, dtype=np.float32)])
    want = np.asarray(ref_privacy.to_fixed({"x": jnp.asarray(x)})["x"])
    got = privacy.to_fixed({"x": torch.from_numpy(x)})["x"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:5].tolist() == [INT32_MAX, INT32_MIN, 0, INT32_MAX, INT32_MIN]
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        back = privacy.from_fixed({"x": got}, dtype)["x"]
        ref_back = np.asarray(ref_privacy.from_fixed({"x": jnp.asarray(want)}, jdt)["x"])
        np.testing.assert_array_equal(back.float().numpy(), ref_back.astype(np.float32))
    # a bf16 update lifts as the reference's does
    xb = torch.from_numpy(x[5:]).bfloat16()
    ref_b = ref_privacy.to_fixed({"x": jnp.asarray(x[5:]).astype(jnp.bfloat16)})["x"]
    np.testing.assert_array_equal(privacy.to_fixed({"x": xb})["x"].numpy(), np.asarray(ref_b))


def test_unguarded_cast_differs_from_reference():
    """The planted fault: PyTorch's plain float → int32 cast, which leaves
    out-of-range values undefined, disagrees with XLA on the CPU."""
    x = torch.from_numpy(SPECIAL)
    unguarded = torch.round(x * privacy.FIXED_POINT_SCALE).to(torch.int32)
    want = np.asarray(ref_privacy.to_fixed({"x": jnp.asarray(SPECIAL)})["x"])
    assert not np.array_equal(unguarded.numpy(), want)
    np.testing.assert_array_equal(privacy.to_fixed({"x": x})["x"].numpy(), want)


def test_wraparound_int32_matches_reference():
    """m + (−1)·x and a + b wrap in both packages, at the ends of the range."""
    m = np.array([5, INT32_MIN, INT32_MAX, -1, 0], np.int32)
    x = np.array([INT32_MIN, INT32_MIN, -1, INT32_MAX, INT32_MIN], np.int32)
    want_sub = np.asarray((jnp.asarray(m) + (-1) * jnp.asarray(x)).astype(jnp.int32))
    got_sub = torch.from_numpy(m.copy()).sub_(torch.from_numpy(x))
    np.testing.assert_array_equal(got_sub.numpy(), want_sub)
    want_sum = np.asarray(ref_privacy.secure_sum([{"a": jnp.asarray(m)}, {"a": jnp.asarray(x)},
                                                   {"a": jnp.asarray(m)}])["a"])
    got_sum = privacy.secure_sum([{"a": torch.from_numpy(m)}, {"a": torch.from_numpy(x)},
                                  {"a": torch.from_numpy(m)}])["a"]
    np.testing.assert_array_equal(got_sum.numpy(), want_sum)


def test_masks_cancel_hide_and_are_bound_to_the_round():
    ups = [_torch(u) for u in _updates(3, 11)]
    fixed = [privacy.to_fixed(u) for u in ups]
    masked = [privacy.mask_update(f, i, 3, 5) for i, f in enumerate(fixed)]
    plain = [x.clone() for x in tree_leaves(fixed[0])]
    for f in fixed[1:]:
        for a, b in zip(plain, tree_leaves(f)):
            a.add_(b)
    for a, b in zip(tree_leaves(privacy.secure_sum(masked)), plain):
        assert torch.equal(a, b)
    # a masked transmit is not its fixed-point update: only chance agreements
    for f, m in zip(fixed, masked):
        same = sum(int((a == b).sum()) for a, b in zip(tree_leaves(f), tree_leaves(m)))
        assert same <= 2, same
    # the same round draws the same masks; another round other ones
    again = privacy.mask_update(fixed[0], 0, 3, 5)
    other = privacy.mask_update(fixed[0], 0, 3, 6)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(masked[0])))
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(other), tree_leaves(masked[0])))
    # planted faults: one cloud on the wrong round, or one pair's mask with
    # the wrong sign (cloud 1 of the pair (0, 1) adds where it subtracts)
    stale = [masked[0], privacy.mask_update(fixed[1], 1, 3, 6), masked[2]]
    flipped = privacy.mask_update(fixed[1], 1, 3, 5)
    gen = privacy._pair_generator(5, 0, 1, "cpu")
    for x in tree_leaves(flipped):
        x.add_(2 * torch.randint(INT32_MIN, INT32_MAX, x.shape, generator=gen,
                                 dtype=torch.int32))
    for bad in (stale, [masked[0], flipped, masked[2]]):
        out = tree_leaves(privacy.secure_sum(bad))
        assert not any(torch.equal(a, b) for a, b in zip(out, plain))


def test_secure_agg_demo_error_and_example_imports_no_jax():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_private_training as ex
    finally:
        sys.path.remove(str(ROOT / "examples"))
    err = ex.secure_agg_demo("cpu")
    assert 0 < err < 3 * 2.0**-17
    code = (
        "import runpy, sys\n"
        "sys.argv = ['torch_private_training.py', '--device', 'cpu', '--steps', '2']\n"
        "runpy.run_path('examples/torch_private_training.py', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "HOME": os.environ.get("HOME", str(pathlib.Path.home())), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert "σ=3.0: final loss" in out and "masks cancel exactly" in out
