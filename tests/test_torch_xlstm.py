"""The port's xLSTM family (``repro_torch.models.xlstm``: mLSTM and sLSTM
blocks, the sLSTM scan's backward as a ``torch.autograd.Function``) and its
recurrent speculative draft (``launch/spec_decode.XlstmDraft``) against the
reference, at the smoke config in float32 on the same numpy-drawn weights
(``repro_torch.bridge.numpy_params``). The recurrent families' federated
training is ``tests/test_torch_recurrent_train.py``.

Tolerances: logits within 1e-5 of their scale (XLA's and torch's sums in
other orders); the mLSTM parallel form against stepping the decode update
within 1e-5 (the stabilized sums regrouped); the sLSTM Function's
gradients within 1e-5 of plain autograd through the cell loop and of
``jax.grad`` of the reference's custom-VJP scan (the same deltas, the
weight gradients summed over (S, B) in another order); speculative greedy
tokens equal.

The golden file the card replays, rewritten by ``PYTHONPATH=src:. python
tests/test_torch_xlstm.py``: ``golden_xlstm_draft_smoke.json`` (the
reference engine's trace of the stablelm-1.6b smoke target with an
xlstm-125m draft)."""
import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import engine as ref_engine
from repro.models import xlstm as ref_xlstm
from repro_torch.bridge import numpy_from_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import engine as port_engine
from repro_torch.launch.spec_decode import XlstmDraft, make_draft_backend
from repro_torch.models import xlstm
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_map
from tests.test_torch_rglru import both_models, close, close_trees

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "xlstm-125m"
TARGET = "stablelm-1.6b"
TESTDATA = ROOT / "src" / "repro_torch" / "testdata"
GOLDEN_DRAFT = TESTDATA / "golden_xlstm_draft_smoke.json"
SPEC_COUNTERS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_emitted")
POOL_COUNTERS = ("prefill_tokens", "prefix_hit_pages", "cow_copies", "suffix_dispatches",
                 "cold_dispatches", "preemptions")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops on one intra-op thread: the suite runs several
    workers at once, and teams of threads per worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ssm():
    return both_models(ARCH)


def test_configs_are_the_references():
    for get, ref_get in ((get_smoke_config, ref_smoke_config), (get_config, ref_get_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(ref_get(ARCH))


def test_params_tree_is_the_references(ssm):
    model, _, ref_model, _ = ssm
    mine = numpy_from_params(model.init(torch.Generator().manual_seed(0), "cpu"))
    want = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    assert ([(x.shape, x.dtype) for x in jax.tree_util.tree_leaves(mine)]
            == [(x.shape, np.float32) for x in jax.tree_util.tree_leaves(want)])
    bf16 = build_model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(0), "cpu")
    blk = bf16["periods"]["pos1"]["blk"]
    assert blk["b_f"].dtype == torch.float32 and blk["w_z"].dtype == torch.bfloat16


def test_forward_and_loss_match_reference(ssm):
    model, params, ref_model, ref_params = ssm
    toks = np.random.default_rng(1).integers(0, 512, (2, 20)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    # one compile for both
    want, want_loss = jax.jit(lambda p, b: (ref_model.forward(p, b), ref_model.loss(p, b)[0]))(
        ref_params, jax.tree_util.tree_map(jnp.asarray, batch))
    close(model.forward(params, {"tokens": torch.from_numpy(batch["tokens"])}), want)
    got_loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _ref_decode():
    _, _, ref_model, _ = both_models(ARCH)
    return jax.jit(ref_model.decode)


def test_prefill_and_24_decode_steps_match_reference(ssm):
    """A 9-token prompt through ``prefill`` (its cache the reference's),
    then 24 teacher-forced decode steps from it and from an empty cache fed
    the prompt first: every step's logits within 1e-5 of the reference's;
    the state's leaves keep their shapes and addresses (in-place decode)."""
    model, params, ref_model, ref_params = ssm
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 512, (2, 9)).astype(np.int32)
    feed = rng.integers(0, 512, (2, 24)).astype(np.int32)
    cache, got = model.prefill(params, torch.from_numpy(prompt))
    jc, want = jax.jit(lambda p, t: ref_model.prefill(p, {"tokens": t}))(ref_params,
                                                                         jnp.asarray(prompt))
    close(got, want)
    close_trees(cache, jc)
    tf = model.init_cache(2, 0, device="cpu")
    for t in range(9):
        tf, tf_logits = model.decode(params, tf, torch.from_numpy(prompt[:, t:t + 1]))
    close(got, tf_logits.numpy())
    before = [(x.shape, x.data_ptr()) for x in jax.tree_util.tree_leaves(cache)]
    dec = _ref_decode()
    for t in range(24):
        x = feed[:, t:t + 1]
        cache, got = model.decode(params, cache, torch.from_numpy(x))
        jc, want = dec(ref_params, jc, jnp.asarray(x))
        close(got, want)
        assert torch.isfinite(got).all()
    assert [(x.shape, x.data_ptr()) for x in jax.tree_util.tree_leaves(cache)] == before
    close_trees(cache, jc)
    assert int(cache["pos"]) == 33


def test_mlstm_parallel_matches_stepping(ssm):
    """The stabilized parallel form (query-chunked: chunks of 5 over 13
    positions) against 13 steps of the decode update, and the final state
    against ``mlstm_final_state``; the reference's parallel form too."""
    rng = np.random.default_rng(3)
    b, s, h, dh = 2, 13, 4, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32))
               for _ in range(3))
    i_pre, f_pre = (torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32) * 2)
                    for _ in range(2))
    par = xlstm.mlstm_parallel(q, k, v, i_pre, f_pre, q_chunk=5)
    torch.testing.assert_close(par, xlstm.mlstm_parallel(q, k, v, i_pre, f_pre), rtol=1e-6,
                               atol=1e-6)
    want = jax.jit(ref_xlstm.mlstm_parallel)(*(jnp.asarray(x.numpy())
                                               for x in (q, k, v, i_pre, f_pre)))
    np.testing.assert_allclose(par.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    state = (torch.zeros(b, h, dh, dh), torch.zeros(b, h, dh), torch.full((b, h), -1e30))
    steps = []
    for t in range(s):
        state, out = xlstm.mlstm_step(state, q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])
        steps.append(out)
    torch.testing.assert_close(par, torch.stack(steps, 1), rtol=1e-5, atol=1e-5)
    c, n, m = xlstm.mlstm_final_state(k, v, i_pre, f_pre)
    torch.testing.assert_close(m, state[2], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(c, state[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(n, state[1], rtol=1e-5, atol=1e-5)


def test_slstm_function_gradients(ssm):
    """``SlstmScan``'s backward against plain autograd through the cell
    loop and against ``jax.grad`` of the reference's ``slstm_scan_train``:
    the gradients of every input and recurrent weight within 1e-5."""
    _, params, _, ref_params = ssm
    rec = {k: params["periods"]["pos1"]["blk"][k][0].clone() for k in xlstm.REC}
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((2, 11, 128)).astype(np.float32) for _ in range(4)]
    w = rng.standard_normal((2, 11, 128)).astype(np.float32)

    def port_grads(fn):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs]
        r = {k: t.detach().requires_grad_(True) for k, t in rec.items()}
        hs = fn(r, *leaves)
        (hs * torch.from_numpy(w)).sum().backward()
        return hs.detach(), [x.grad for x in leaves], {k: t.grad for k, t in r.items()}

    def loop(r, xz, xi, xf, xo):
        zero = torch.zeros(2, 128)
        st = {"c": zero, "n": zero, "h": zero, "m": torch.full((2, 128), -1e30)}
        out = []
        for t in range(xz.shape[1]):
            st = xlstm.slstm_cell(r, xz[:, t], xi[:, t], xf[:, t], xo[:, t], st)
            out.append(st["h"])
        return torch.stack(out, 1)

    hs, dx, dr = port_grads(xlstm.slstm_scan_train)
    hs_l, dx_l, dr_l = port_grads(loop)
    torch.testing.assert_close(hs, hs_l, rtol=1e-6, atol=1e-6)
    for a, b in zip(dx, dx_l):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for k in xlstm.REC:
        torch.testing.assert_close(dr[k], dr_l[k], rtol=1e-5, atol=1e-5)

    jrec = {k: jnp.asarray(rec[k].numpy()) for k in xlstm.REC}

    def objective(r, *x):
        return jnp.sum(ref_xlstm.slstm_scan_train(r, *x) * jnp.asarray(w))

    jdr, *jdx = jax.jit(jax.grad(objective, argnums=(0, 1, 2, 3, 4)))(
        jrec, *(jnp.asarray(x) for x in xs))
    for a, b in zip(dx, jdx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for k in xlstm.REC:
        np.testing.assert_allclose(dr[k].numpy(), np.asarray(jdr[k]), rtol=1e-5, atol=1e-5)


def test_select_rows_and_gather_snapshots_match_reference(ssm):
    """The draft's state surgery against the reference's, on a 2-layer
    cache (a period leaf at batch axis 1) with 3 rows and 4 snapshots."""
    model, _, _, _ = ssm
    rng = np.random.default_rng(5)

    def rand_state():
        c = model.init_cache(3, 0, device="cpu")
        return tree_map(lambda x: torch.from_numpy(rng.standard_normal(x.shape)
                                                   .astype(np.float32)), xlstm.state_tree(c))

    a, b = rand_state(), rand_state()
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, numpy_from_params(t))  # noqa: E731
    cond = np.array([True, False, True])
    got = xlstm.select_rows(torch.from_numpy(cond), a, b)
    pos = {"pos": jnp.zeros((), jnp.int32)}
    want = jax.jit(ref_xlstm.select_rows)(jnp.asarray(cond), {**j(a), **pos}, {**j(b), **pos})
    close_trees(got, {"periods": want["periods"], "rest": want["rest"]}, rtol=0)
    snaps = _stack_states([rand_state() for _ in range(4)])
    idx = np.array([3, 0, 2], np.int32)
    got = xlstm.gather_snapshots(snaps, torch.from_numpy(idx))
    want = jax.jit(ref_xlstm.gather_snapshots)({**j(snaps), **pos}, jnp.asarray(idx))
    close_trees(got, {"periods": want["periods"], "rest": want["rest"]}, rtol=0)


def _stack_states(states: list) -> dict:
    leaves = [jax.tree_util.tree_leaves(s) for s in states]
    it = iter([torch.stack(xs) for xs in zip(*leaves)])
    return tree_map(lambda _: next(it), states[0])


# ------------------------------------------------------------ the draft
P, G, K = 12, 8, 3


def draft_trace() -> dict:
    """The engine trace with an xlstm-125m draft (its own weights, seed 0)
    over the stablelm-1.6b smoke target: 3 requests over 2 slots, so a slot
    is reused and the draft re-syncs it."""
    rng = np.random.default_rng(6)
    return {
        "config": f"{TARGET} smoke target, {ARCH} smoke draft, dtype float32",
        "seed": 0, "draft_seed": 0, "spec_tokens": K, "max_new_tokens": G,
        "engine": dict(num_slots=2, max_seq=P + G + 4, paged_cache=True, page_size=4),
        "prompts": [rng.integers(1, 512, n).tolist() for n in (P, P - 3, P - 5)],
    }


def _engines(g, port: bool):
    """(target model, target params, draft model, draft params) of the port
    or of the reference."""
    t = both_models(TARGET, g["seed"])
    d = both_models(ARCH, g["draft_seed"])
    return (t[0], t[1], d[0], d[1]) if port else (t[2], t[3], d[2], d[3])


@functools.lru_cache(maxsize=None)
def _reference_draft() -> str:
    g = draft_trace()
    tm, tp, dm, dp = _engines(g, False)
    eng = ref_engine.ServeEngine(tm, tp, draft_model=dm, draft_params=dp,
                                 spec_tokens=g["spec_tokens"], **g["engine"])
    outs = eng.run([ref_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                       max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    g["tokens"] = [[int(t) for t in o.tokens] for o in outs]
    g["counters"] = {k: int(eng.pool_stats[k]) for k in SPEC_COUNTERS + POOL_COUNTERS}
    return json.dumps(g)


def make_golden_draft() -> dict:
    return json.loads(_reference_draft())


def replay_draft(g: dict, device, graphs: bool = True) -> tuple[list, dict, object]:
    """The port's engine on the draft trace: (tokens, counters, engine)."""
    tm, tp, dm, dp = _engines(g, True)
    if device != "cpu":
        tp, dp = (tree_map(lambda x: x.to(device), p) for p in (tp, dp))
    eng = port_engine.ServeEngine(tm, tp, device=device, draft_model=dm, draft_params=dp,
                                  spec_tokens=g["spec_tokens"], graphs=graphs, **g["engine"])
    outs = eng.run([port_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                        max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    return [o.tokens for o in outs], {k: eng.pool_stats[k] for k in g["counters"]}, eng


def test_golden_draft_file_matches_reference():
    assert json.loads(GOLDEN_DRAFT.read_text()) == make_golden_draft()


def test_xlstm_draft_greedy_tokens_equal_the_plain_engine():
    """``make_draft_backend`` gives an ``XlstmDraft`` for the ssm draft; the
    speculative engine's greedy tokens are the plain engine's and the
    reference speculative engine's, with its counters; a draft that has
    neither a slot-cache API nor recurrent state is refused."""
    g = json.loads(GOLDEN_DRAFT.read_text())
    tokens, counters, eng = replay_draft(g, "cpu")
    assert isinstance(eng.draft, XlstmDraft)
    tm, tp, _, _ = _engines(g, True)
    plain = port_engine.ServeEngine(tm, tp, device="cpu", **g["engine"])
    outs = plain.run([port_engine.Request(uid=u, prompt=np.asarray(p, np.int32),
                                          max_new_tokens=g["max_new_tokens"])
                      for u, p in enumerate(g["prompts"])])
    assert tokens == [o.tokens for o in outs] == g["tokens"]
    assert counters == g["counters"] and counters["spec_rounds"] > 0
    hybrid = build_model(get_smoke_config("recurrentgemma-2b"))
    with pytest.raises(ValueError, match="neither a slot-cache API"):
        make_draft_backend(hybrid, {}, num_slots=2, cap=16, spec_tokens=2, device="cpu")


if __name__ == "__main__":
    GOLDEN_DRAFT.write_text(json.dumps(make_golden_draft(), indent=1) + "\n")
    print(f"wrote {GOLDEN_DRAFT}")
