"""The port's federated substrate against the JAX reference: optimizers,
the client update, aggregation, the int8 uplink on stacked cohort deltas,
FedAvg == centralized, and the synthetic data.

All f32 on the CPU. Tolerances: client updates 1e-5 (the reference's
client-step tolerance); optimizers 1e-6 (one f32 power and a few
elementwise ops per step); the codec bit-equal (the port's plain codec and
the reference oracle both divide in IEEE f32); data exactly equal.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import FederatedConfig as JFed  # noqa: E402
from repro.configs import RunConfig as JRun  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import FederatedDataset as JDataset  # noqa: E402
from repro.data import client_num_samples as jclient_num_samples  # noqa: E402
from repro.federated import aggregation as jagg  # noqa: E402
from repro.federated.client import make_client_update as jmake_update  # noqa: E402
from repro.federated.client import stack_batches as jstack  # noqa: E402
from repro.federated.real import RealLearner as JLearner  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import FederatedConfig, RunConfig  # noqa: E402
from repro_torch.configs import model_config_from_dict  # noqa: E402
from repro_torch.data import FederatedDataset, client_num_samples  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402
from repro_torch.federated.client import (make_client_update,  # noqa: E402
                                          stack_batches, to_device)
from repro_torch.federated.real import RealLearner  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)


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
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=get_model(cfg),
                jparams=jparams, np_params=np_params,
                params=params_from_jax(np_params, "cpu", cfg),
                jds=JDataset(**kw), ds=FederatedDataset(**kw))


# ----------------------------------------------------------------- optimizers

@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_match_jax(name):
    rng = np.random.default_rng(5)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((3,)).astype(np.float32)}
    jopt = joptim.server_optimizer(name, 0.01, b1=0.9, b2=0.999, eps=1e-8)
    topt = toptim.server_optimizer(name, 0.01, b1=0.9, b2=0.999, eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, err_msg=f"{name} {k}")
    assert int(ts["step"]) == int(js["step"]) == 5
    with pytest.raises(ValueError):
        toptim.server_optimizer("nope", 0.1)


def test_adam_first_step_and_f32_moments():
    """Adam's first step moves each weight by lr against the grad's sign,
    and keeps f32 moments."""
    opt = toptim.adam(0.001)
    params = {"w": torch.tensor([1.0, 2.0])}
    st = opt.init(params)
    p, st = opt.update({"w": torch.tensor([0.1, -0.2])}, st, params)
    np.testing.assert_allclose(p["w"].numpy(), [0.999, 2.001], atol=1e-5)
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32


# -------------------------------------------------------------- client update

def test_client_update_matches_jax(tiny):
    """Three real steps and one padding step, with the global-norm clip
    active (max norm 0.5), against the reference's scanned update."""
    batches = tiny["jds"].client_batches(7, batch_size=4)[:3]
    stacked, mask = jstack(batches, 4)
    jupd = jmake_update(tiny["jmodel"].loss, client_lr=0.1, max_grad_norm=0.5)
    jdelta, jloss = jupd(tiny["jparams"], stacked, mask)
    upd = make_client_update(tiny["model"].loss, client_lr=0.1,
                             max_grad_norm=0.5)
    delta, loss = upd(tiny["params"], to_device(stacked, "cpu"), mask)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in delta:
        np.testing.assert_allclose(delta[k].numpy(), np.asarray(jdelta[k]),
                                   atol=1e-5, err_msg=k)


def test_client_update_is_sgd(tiny):
    """One local step with one batch == a plain SGD step."""
    batch = tiny["ds"].client_batches(7, batch_size=4)[:1]
    stacked, mask = stack_batches(batch, 1)
    upd = make_client_update(tiny["model"].loss, client_lr=0.1,
                             max_grad_norm=1e9)
    delta, _ = upd(tiny["params"], to_device(stacked, "cpu"), mask)
    params = {k: v.clone().requires_grad_(True)
              for k, v in tiny["params"].items()}
    loss = tiny["model"].loss(params, to_device(batch[0], "cpu"))[0]
    grads = torch.autograd.grad(loss, list(params.values()))
    for k, g in zip(params, grads):
        np.testing.assert_allclose(delta[k].numpy(), -0.1 * g.numpy(),
                                   atol=1e-5, err_msg=k)


def test_padding_steps_are_noops(tiny):
    batches = tiny["ds"].client_batches(7, batch_size=4)[:1]
    upd = make_client_update(tiny["model"].loss, client_lr=0.1)
    s1, m1 = stack_batches(batches, 1)
    s4, m4 = stack_batches(batches, 4)          # 3 padded steps
    d1, l1 = upd(tiny["params"], to_device(s1, "cpu"), m1)
    d4, l4 = upd(tiny["params"], to_device(s4, "cpu"), m4)
    assert float(l1) == float(l4)
    for k in d1:
        assert torch.equal(d1[k], d4[k]), k


def test_stack_batches_matches_jax(tiny):
    batches = tiny["ds"].client_batches(3, batch_size=4)
    for n in (1, len(batches), len(batches) + 2):
        got, gm = stack_batches(batches, n)
        want, wm = jstack(batches, n)
        np.testing.assert_array_equal(gm, wm)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------- aggregation

def test_weighted_mean_deltas_matches_jax():
    out = tagg.weighted_mean_deltas({"w": torch.tensor([[1.0, 1.0],
                                                        [3.0, 3.0]])},
                                    torch.tensor([1.0, 3.0]))
    np.testing.assert_allclose(out["w"].numpy(), [2.5, 2.5])
    rng = np.random.default_rng(2)
    d = {"a": rng.standard_normal((5, 3, 4)).astype(np.float32),
         "b": rng.standard_normal((5, 7)).astype(np.float32)}
    for w in (rng.uniform(0.5, 3, 5).astype(np.float32),
              np.zeros(5, np.float32)):          # all-zero: eps normaliser
        want = jagg.weighted_mean_deltas({k: jnp.asarray(v)
                                          for k, v in d.items()},
                                         jnp.asarray(w))
        got = tagg.weighted_mean_deltas({k: torch.tensor(v)
                                         for k, v in d.items()},
                                        torch.tensor(w))
        for k in d:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-6)


@pytest.mark.parametrize("staleness,alpha", [([0, 1, 5, 16], 0.5),
                                             ([3, 0, 0, 50, 2], 0.9)])
def test_fedbuff_weights_match_jax(staleness, alpha):
    np.testing.assert_array_equal(tagg.fedbuff_weights(staleness, alpha),
                                  jagg.fedbuff_weights(staleness, alpha))


def test_compress_roundtrip_stacked_cohort_is_bit_equal(tiny):
    """Stacked (N, ...) cohort deltas, as the sync path compresses them.
    The tiny model's biases (16 and 32 elements) are not multiples of the
    256-element block, so a block spans several clients' rows; client i's
    delta is scaled by 10**i so that sharing a block shows."""
    rng = np.random.default_rng(9)
    n = 3
    stacked = {k: np.stack([rng.standard_normal(v.shape).astype(np.float32)
                            * np.float32(10.0 ** i) for i in range(n)])
               for k, v in tiny["np_params"].items()}
    want = jagg.compress_roundtrip({k: jnp.asarray(v)
                                    for k, v in stacked.items()}, block=256)
    got = tagg.compress_roundtrip({k: torch.tensor(v)
                                   for k, v in stacked.items()}, block=256)
    for k in stacked:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the per-client path quantizes each client alone: for a straddling
    # bias the small-scale client keeps far more precision that way
    b = "cnn/b2"
    assert stacked[b][0].size * n <= 256
    alone = tagg.compress_roundtrip({b: torch.tensor(stacked[b][0])})[b]
    err_alone = np.abs(alone.numpy() - stacked[b][0]).max()
    err_stacked = np.abs(got[b][0].numpy() - stacked[b][0]).max()
    assert err_stacked > 10 * err_alone


# --------------------------------------------------------------- the learner

def test_fedavg_single_client_equals_centralized(tiny):
    """concurrency=1, E=1, server SGD lr=1 => server params move exactly by
    the client delta; the delta equals the JAX learner's."""
    kw = dict(mode="sync", concurrency=1, aggregation_goal=1, client_lr=0.05,
              server_lr=1.0, server_optimizer="sgd", client_batch_size=4)
    lr = RealLearner(tiny["cfg"], FederatedConfig(**kw), RunConfig(max_rounds=1),
                     tiny["ds"], max_client_steps=2, device="cpu",
                     init_params=tiny["np_params"])
    p0 = {k: v.clone() for k, v in lr.params.items()}
    d, w = lr.client_delta(42, None)
    lr.apply([d], [w])
    for k in p0:
        np.testing.assert_allclose(lr.params[k].numpy(),
                                   (p0[k] + d[k]).numpy(), atol=1e-5)
    jl = JLearner(tiny["jcfg"], JFed(**kw), JRun(max_rounds=1), tiny["jds"],
                  max_client_steps=2)
    jl.params = tiny["jparams"]
    jd, jw = jl.client_delta(42, None)
    assert w == jw
    for k in d:
        np.testing.assert_allclose(d[k].numpy(), jd[k], atol=1e-5)


def test_learner_refuses_a_missing_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealLearner(tiny["cfg"], FederatedConfig(concurrency=1,
                                                 aggregation_goal=1),
                    RunConfig(), tiny["ds"])


# ----------------------------------------------------------------------- data

@pytest.mark.parametrize("seed", [0, 3])
def test_dataset_matches_jax(seed):
    kw = dict(vocab_size=300, seq_len=12, seed=seed, char_vocab=40,
              max_word_len=9)
    ds, jds = FederatedDataset(**kw), JDataset(**kw)
    for cid in (0, 17, 123_456):
        assert client_num_samples(cid, seed) == jclient_num_samples(cid, seed)
        got, want = ds.client_batches(cid, 5, 2), jds.client_batches(cid, 5, 2)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    ge, we = ds.eval_batch(7, 32), jds.eval_batch(7, 32)
    for k in ge:
        np.testing.assert_array_equal(ge[k], we[k])
