"""The port's vmapped cohort step against the JAX reference and against the
port's own per-client step: the learner's ``client_deltas`` and
``client_delta``, ``make_cohort_update`` client by client, masked steps,
per-client clipping, fresh deltas, and ``lm_loss`` without its checkpoint.

All f32 on the CPU, on tests/test_torch_federated.py's tiny CharLM with
the JAX init. Tolerances: deltas atol 1e-5 (the reference's client-step
tolerance); with the int8 codec, perplexity after one apply within rtol
1e-3 (a delta that differs in its last bit can flip one rounding at a .5
boundary of the codec); lm_loss and its gradients rtol 1e-5 / atol 1e-5
against JAX, exactly equal with and without the checkpoint.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.configs import FederatedConfig as JFed  # noqa: E402
from repro.configs import RunConfig as JRun  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import FederatedDataset as JDataset  # noqa: E402
from repro.federated.real import RealLearner as JLearner  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.configs import FederatedConfig, RunConfig  # noqa: E402
from repro_torch.configs import model_config_from_dict  # noqa: E402
from repro_torch.data import FederatedDataset  # noqa: E402
from repro_torch.federated.client import (make_client_update,  # noqa: E402
                                          make_cohort_update, stack_batches,
                                          to_device)
from repro_torch.federated.real import RealLearner  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

MAX_STEPS = 4
BATCH = 4


def _tiny_charlm():
    """tests/test_federated.py's tiny config."""
    return dataclasses.replace(
        jreduced(jget_config("paper-charlm"), layers=1, d_model=32, d_ff=32,
                 vocab=128),
        lstm_hidden=32, max_context=8)


@pytest.fixture(scope="module")
def tiny():
    jcfg = _tiny_charlm()
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    jmodel = jget_model(jcfg)
    jparams = jax.jit(lambda r: jmodel.init(r)[0])(jax.random.PRNGKey(0))
    np_params = jax.device_get(jparams)
    kw = dict(vocab_size=jcfg.vocab_size, seq_len=8,
              char_vocab=jcfg.char_vocab, max_word_len=jcfg.max_word_len)
    ds = FederatedDataset(**kw)
    # a ragged cohort: one client for each step count 1..MAX_STEPS, twice
    by_steps = {}
    for cid in range(1000):
        s = min(len(ds.client_batches(cid, BATCH)), MAX_STEPS)
        by_steps.setdefault(s, [])
        if len(by_steps[s]) < 2:
            by_steps[s].append(cid)
        if all(len(by_steps.get(s, [])) == 2
               for s in range(1, MAX_STEPS + 1)):
            break
    cohort = [c for s in range(MAX_STEPS, 0, -1) for c in by_steps[s]]
    return dict(jcfg=jcfg, cfg=cfg, model=get_model(cfg), jparams=jparams,
                np_params=np_params,
                params=params_from_jax(np_params, "cpu", cfg),
                jds=JDataset(**kw), ds=ds, cohort=cohort)


def _learners(tiny, compression):
    kw = dict(mode="sync", concurrency=8, aggregation_goal=8, client_lr=0.3,
              server_lr=0.02, client_batch_size=BATCH,
              compression=compression)
    jl = JLearner(tiny["jcfg"], JFed(**kw), JRun(eval_clients=4),
                  tiny["jds"], max_client_steps=MAX_STEPS)
    jl.params = tiny["jparams"]
    tl = RealLearner(tiny["cfg"], FederatedConfig(**kw), RunConfig(
        eval_clients=4), tiny["ds"], max_client_steps=MAX_STEPS,
        device="cpu", init_params=tiny["np_params"])
    return jl, tl


def _stacked(tiny, ids, n_steps=MAX_STEPS):
    st, ms = zip(*(stack_batches(tiny["ds"].client_batches(c, BATCH),
                                 n_steps) for c in ids))
    return ({k: np.stack([s[k] for s in st]) for k in st[0]},
            np.stack(ms), st, ms)


def test_cohort_is_ragged(tiny):
    steps = [min(len(tiny["ds"].client_batches(c, BATCH)), MAX_STEPS)
             for c in tiny["cohort"]]
    assert sorted(set(steps)) == list(range(1, MAX_STEPS + 1))


@pytest.mark.parametrize("call", ["client_deltas", "client_delta"])
def test_learner_deltas_match_jax(tiny, call):
    """The port's cohort step against the JAX learner's vmapped
    client_deltas, and at N = 1 against its client_delta, no codec."""
    jl, tl = _learners(tiny, "none")
    if call == "client_deltas":
        jd, jw = jl.client_deltas(tiny["cohort"])
        td, tw = tl.client_deltas(tiny["cohort"])
    else:
        jd, jw = zip(*(jl.client_delta(c) for c in tiny["cohort"]))
        td, tw = zip(*(tl.client_delta(c) for c in tiny["cohort"]))
    assert list(tw) == list(jw)
    assert len(td) == len(jd) == len(tiny["cohort"])
    for i, (t, j) in enumerate(zip(td, jd)):
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                       atol=1e-5, err_msg=f"client {i} {k}")


def test_learner_int8_round_matches_jax(tiny):
    """The same ragged cohort through the int8 codec (stacked, so a block
    spans clients), one FedAdam apply, then the eval perplexity."""
    jl, tl = _learners(tiny, "int8")
    for lr in (jl, tl):
        d, w = lr.client_deltas(tiny["cohort"])
        lr.apply(d, w, n_contributors=len(tiny["cohort"]))
    np.testing.assert_allclose(tl.eval_perplexity(), jl.eval_perplexity(),
                               rtol=1e-3)


@pytest.mark.parametrize("max_grad_norm", [10.0, 0.5])
def test_cohort_update_matches_client_update(tiny, max_grad_norm):
    """make_cohort_update against make_client_update run client by client
    (the plain version it is held to), without and with the clip active.
    Both run the same float operations in the same order, so on the CPU
    the deltas and losses come out bit-equal; the contract is 1e-5."""
    cohort, mask, st, ms = _stacked(tiny, tiny["cohort"])
    kw = dict(client_lr=0.3, max_grad_norm=max_grad_norm)
    deltas, losses = make_cohort_update(tiny["model"].loss, **kw)(
        tiny["params"], to_device(cohort, "cpu"), mask)
    upd = make_client_update(tiny["model"].loss, **kw)
    for i, (s, m) in enumerate(zip(st, ms)):
        d, loss = upd(tiny["params"], to_device(s, "cpu"), m)
        np.testing.assert_allclose(float(losses[i]), float(loss), rtol=1e-5)
        for k in d:
            assert deltas[k].shape[0] == len(st)
            np.testing.assert_allclose(deltas[k][i].numpy(), d[k].numpy(),
                                       atol=1e-5, err_msg=f"client {i} {k}")


def test_masked_steps_keep_params(tiny):
    """A client whose mask is 0 at a step keeps its params exactly: client
    0 skips step 1 of 3, client 1 trains no step at all, and the cohort
    runs on for client 2's three steps."""
    ids = tiny["cohort"][:3]
    cohort, mask, st, ms = _stacked(tiny, ids, 3)
    mask[:] = 1.0
    mask[0, 1] = 0.0
    mask[1] = 0.0
    upd = make_cohort_update(tiny["model"].loss, client_lr=0.3)
    deltas, losses = upd(tiny["params"], to_device(cohort, "cpu"), mask)
    assert float(losses[1]) == 0.0
    for k in deltas:
        assert not torch.any(deltas[k][1]), k
    # client 0 alone, with its masked step taken out of its batches
    one = {k: v[:1][:, [0, 2]] for k, v in cohort.items()}
    alone, _ = upd(tiny["params"], to_device(one, "cpu"),
                   np.ones((1, 2), np.float32))
    for k in deltas:
        assert torch.equal(deltas[k][0], alone[k][0]), k


def _norm(d, i=None):
    return float(torch.sqrt(sum(torch.sum(torch.square(
        v if i is None else v[i])) for v in d.values())))


def test_clipping_is_per_client(tiny):
    """One step each, with the clip between the two clients' gradient
    norms: the client with the larger gradient is clipped to the clip norm,
    its neighbour moves by lr times its own gradient."""
    ids = tiny["cohort"][:2]
    cohort, mask, _, _ = _stacked(tiny, ids, 1)
    big = make_cohort_update(tiny["model"].loss, client_lr=1.0,
                             max_grad_norm=1e9)
    free, _ = big(tiny["params"], to_device(cohort, "cpu"), mask)
    norms = [_norm(free, i) for i in range(2)]
    lo, hi = sorted(norms)
    assert hi > 1.05 * lo, norms
    clip = (lo + hi) / 2
    upd = make_cohort_update(tiny["model"].loss, client_lr=1.0,
                             max_grad_norm=clip)
    got, _ = upd(tiny["params"], to_device(cohort, "cpu"), mask)
    for i in range(2):
        if norms[i] == hi:
            np.testing.assert_allclose(_norm(got, i), clip, rtol=1e-5)
        else:
            for k in got:
                assert torch.equal(got[k][i], free[k][i]), k


def test_client_delta_is_not_overwritten(tiny):
    """With no codec a delta is a fresh tensor: a second client_delta on
    another client leaves the first one as it was."""
    _, tl = _learners(tiny, "none")
    d1, _ = tl.client_delta(tiny["cohort"][0])
    kept = {k: v.clone() for k, v in d1.items()}
    tl.client_delta(tiny["cohort"][1])
    tl.client_deltas(tiny["cohort"][2:4])
    for k in kept:
        assert torch.equal(d1[k], kept[k]), k


def _loss_inputs(seed, n_words):
    rng = np.random.default_rng(seed)
    B, d, V = 3, 8, 20
    x = rng.standard_normal((B, n_words, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, n_words)).astype(np.int64)
    mask = (rng.uniform(size=(B, n_words - 1)) < 0.8).astype(np.float32)
    return x, w, labels, mask


def _torch_loss_and_grads(x, w, labels, mask, loss_fn):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = loss_fn(xt, wt, torch.tensor(labels), torch.tensor(mask))
    gx, gw = torch.autograd.grad(loss, [xt, wt])
    return loss.detach(), gx, gw


def test_lm_loss_one_chunk_matches_checkpointed():
    """At one chunk lm_loss takes no checkpoint; the loss and gradients
    equal those of the checkpointed chunk exactly, and torch.func can now
    differentiate it."""
    x, w, labels, mask = _loss_inputs(0, 9)

    def checkpointed(xt, wt, lt, mt):
        return checkpoint(cm._chunk_nll_sum, xt[:, :-1], wt, lt[:, 1:],
                          mt, use_reentrant=False) / torch.clamp(
                              torch.sum(mt), min=1.0)

    got = _torch_loss_and_grads(x, w, labels, mask, cm.lm_loss)
    want = _torch_loss_and_grads(x, w, labels, mask, checkpointed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    gw = torch.func.grad(lambda wt: cm.lm_loss(
        torch.tensor(x), wt, torch.tensor(labels), torch.tensor(mask)))(
            torch.tensor(w))
    assert torch.equal(gw, got[2])


@pytest.mark.parametrize("chunk", [256, 4, 3])
def test_lm_loss_matches_jax(chunk):
    """One chunk, two chunks, and three with a ragged last chunk (the
    checkpointed path), value and gradients against the JAX lm_loss."""
    x, w, labels, mask = _loss_inputs(1, 9)
    loss, gx, gw = _torch_loss_and_grads(
        x, w, labels, mask, lambda *a: cm.lm_loss(*a, chunk=chunk))
    jloss, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: jcm.lm_loss(a, b, jnp.asarray(labels),
                                 jnp.asarray(mask), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-5)


def test_char_embedding_gradient_is_reproducible_on_many_threads(tiny):
    """Run to run, the gradient of the CharLM's word embedding for a
    stacked cohort (vmapped, as the cohort step takes it) has the same bits
    on 4 CPU threads. On the CPU the char lookup is an embedding, whose
    backward sums each row in one fixed order; indexing's backward (the
    CPU's lookup before) adds rows with atomics across threads, and its
    runs differed in the last bits."""
    model, cfg = tiny["model"], tiny["cfg"]
    n = 6
    params = {k: v.expand((n,) + tuple(v.shape)).clone()
              for k, v in tiny["params"].items()}
    gen = torch.Generator().manual_seed(0)
    chars = torch.randint(0, cfg.char_vocab, (n, 8, 16, cfg.max_word_len),
                          generator=gen)
    weight = torch.randn(n, 8, 16, cfg.d_model, generator=gen)

    def loss(p, c, w):
        return (model.word_embed(p, c) * w).sum()
    grad = torch.func.vmap(torch.func.grad(loss))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        first = grad(params, chars, weight)["char_embed"]
        for _ in range(200):
            assert torch.equal(grad(params, chars, weight)["char_embed"],
                               first)
    finally:
        torch.set_num_threads(threads)
