"""The port's CharLM against the JAX reference model on transferred
weights: init keys and shapes, the char-CNN word encoder, loss and every
gradient, prefill and decode logits, and the parameter count.

All in f32 on the CPU. Tolerances: loss rtol 1e-5 and grads atol 1e-5, the
reference's client-step tolerance; word embeddings and logits atol 1e-5
(sums taken in another order by the two frameworks differ in the last
bits).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import FederatedDataset  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import param_count as jparam_count  # noqa: E402
from repro.models import param_shapes_and_axes  # noqa: E402
from repro_torch.configs import get_config, model_config_from_dict  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.federated.client import to_device  # noqa: E402
from repro_torch.models import get_model, param_count  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_numpy  # noqa: E402

torch.set_num_threads(2)


def _tiny_charlm(jcfg):
    """tests/test_federated.py's tiny config."""
    return dataclasses.replace(
        jreduced(jcfg, layers=1, d_model=32, d_ff=32, vocab=128),
        lstm_hidden=32, max_context=8)


def _two_layer_full_filters(jcfg):
    """Two LSTM layers and the paper's six char-CNN filter widths."""
    return dataclasses.replace(
        jreduced(jcfg, layers=2, d_model=48, d_ff=40, vocab=96),
        lstm_hidden=48, cnn_filters=jcfg.cnn_filters)


CONFIGS = {"tiny": _tiny_charlm, "two_layer_full_filters": _two_layer_full_filters}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    jcfg = CONFIGS[request.param](jget_config("paper-charlm"))
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    jmodel, model = jget_model(jcfg), get_model(cfg)
    jparams = jax.jit(lambda r: jmodel.init(r)[0])(jax.random.PRNGKey(1))
    np_params = jax.device_get(jparams)
    params = params_from_jax(np_params, "cpu", cfg)
    ds = FederatedDataset(vocab_size=jcfg.vocab_size, seq_len=8,
                          char_vocab=jcfg.char_vocab,
                          max_word_len=jcfg.max_word_len)
    batch = ds.client_batches(11, batch_size=4)[0]
    batch["mask"][-1, -3:] = 0.0          # exercise the (B, S-1) mask
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jparams=jparams, params=params, batch=batch)


def test_config_roundtrip_and_registry():
    jcfg = jget_config("paper-charlm")
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg == get_config("paper-charlm")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg, layers=1, d_model=32)) == \
        dataclasses.asdict(jreduced(jcfg, layers=1, d_model=32))
    with pytest.raises(KeyError, match="not ported yet"):
        get_config("recurrentgemma-2b")


def test_full_width_param_count():
    """Shapes only, no allocation on either side."""
    cfg = get_config("paper-charlm")
    assert param_count(cfg) == cfg.param_count() == 15_560_704
    assert jparam_count(jget_config("paper-charlm")) == 15_560_704


def test_init_keys_and_shapes(setup):
    params, axes = setup["model"].init(torch.Generator().manual_seed(0))
    jparams = setup["jparams"]
    jaxes = param_shapes_and_axes(setup["jcfg"])[1]
    assert sorted(params) == sorted(jparams)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    assert axes == jaxes
    assert all(v.dtype == torch.float32 for v in params.values())
    # the same seeded init on every call (CPU generator)
    again, _ = setup["model"].init(torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)
    # init kinds and scales follow the reference: zeros for biases, normal
    # with std 1/sqrt(fan_in), 0.1 for the char embedding
    assert float(params["cnn/b1" if "cnn/b1" in params else "cnn/b2"]
                 .abs().max()) == 0.0
    assert abs(float(params["char_embed"].std()) - 0.1) < 0.02


def test_word_embed_matches_jax(setup):
    chars = setup["batch"]["chars"]
    want = jax.jit(setup["jmodel"].word_embed)(setup["jparams"],
                                               jnp.asarray(chars))
    got = setup["model"].word_embed(setup["params"], torch.tensor(chars))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_loss_and_grads_match_jax(setup):
    jmodel, model = setup["jmodel"], setup["model"]
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True))(setup["jparams"])
    params = {k: v.clone().requires_grad_(True)
              for k, v in setup["params"].items()}
    loss, metrics = model.loss(params, to_device(setup["batch"], "cpu"))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["perplexity"].item(),
                               float(np.exp(float(jloss))), rtol=1e-5)
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   atol=1e-5, err_msg=k)


def test_loss_chunks_do_not_change_the_value(setup):
    """lm_loss over several sequence chunks equals one chunk."""
    from repro_torch.models import common as cm
    x = torch.tensor(np.random.default_rng(0).standard_normal((3, 9, 8)),
                     dtype=torch.float32)
    w = torch.tensor(np.random.default_rng(1).standard_normal((8, 17)),
                     dtype=torch.float32)
    labels = torch.tensor(np.random.default_rng(2).integers(0, 17, (3, 9)))
    mask = torch.ones(3, 8)
    mask[1, 5:] = 0
    one = cm.lm_loss(x, w, labels, mask, chunk=256)
    many = cm.lm_loss(x, w, labels, mask, chunk=3)
    np.testing.assert_allclose(float(many), float(one), rtol=1e-6)


def test_prefill_and_decode_match_jax(setup):
    jmodel, model = setup["jmodel"], setup["model"]
    chars = setup["batch"]["chars"]                # (B, S, W)
    jlg, jst = jax.jit(lambda p, c: jmodel.prefill(p, None, chars=c))(
        setup["jparams"], jnp.asarray(chars[:, :-1]))
    lg, st = model.prefill(setup["params"], None,
                           chars=torch.tensor(chars[:, :-1]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-5)
    assert int(st["pos"]) == int(jst["pos"]) == chars.shape[1] - 1
    jlg2, jst2 = jax.jit(jmodel.decode_step)(setup["jparams"], jst,
                                             jnp.asarray(chars[:, -1]))
    lg2, st2 = model.decode_step(setup["params"], st,
                                 torch.tensor(chars[:, -1]))
    np.testing.assert_allclose(lg2.numpy(), np.asarray(jlg2), atol=1e-5)
    for k in ("h", "c"):
        np.testing.assert_allclose(st2[k].numpy(), np.asarray(jst2[k]),
                                   atol=1e-5)
    assert int(st2["pos"]) == int(jst2["pos"]) == chars.shape[1]
    # decoding the last word equals prefilling the whole sequence
    full, _ = model.prefill(setup["params"], None, chars=torch.tensor(chars))
    np.testing.assert_allclose(lg2.numpy(), full.numpy(), atol=1e-5)


def test_weight_transfer_roundtrip_and_checks(setup):
    np_params = params_to_numpy(setup["params"])
    back = params_from_jax(np_params, "cpu", setup["cfg"])
    assert all(torch.equal(back[k], setup["params"][k]) for k in back)
    bad = dict(np_params)
    bad["proj_in"] = bad["proj_in"][:-1]
    with pytest.raises(ValueError, match="proj_in"):
        params_from_jax(bad, "cpu", setup["cfg"])
    bad = dict(np_params)
    del bad["unembed"]
    with pytest.raises(ValueError, match="unembed"):
        params_from_jax(bad, "cpu", setup["cfg"])
