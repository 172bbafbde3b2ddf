"""The port's command lines against the reference package's: the spec CLI
(``python -m repro_torch.api``) and the train CLI
(``python -m repro_torch.launch.train``) write the reference's spec and
result JSON; checkpoints cross-load both ways; the example twins under
``examples/torch`` import neither JAX nor the reference package.

A real run through the CLIs starts the port's learner from its own seeded
init, which is not JAX's; the reduced real run here starts it from the JAX
learner's init (the CLI's Experiment is given that learner) and is held
as ``tests/test_torch_experiment.py`` holds the port's learner in the
engine: every summary key equal but the perplexity, within rel 1e-4.
"""
import ast
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.api.__main__ as ref_api_cli  # noqa: E402
import repro.launch.train as ref_train  # noqa: E402
from repro.api import Experiment as RefExperiment  # noqa: E402
from repro.api import ExperimentSpec as RefSpec  # noqa: E402
from repro.checkpoint import load_checkpoint as ref_load  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
import repro_torch.api.__main__ as api_cli  # noqa: E402
from repro_torch.api import Experiment, ExperimentSpec  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.federated import RealLearner  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SPECS = sorted((REPO / "examples" / "specs").glob("*.json"))
TWINS = sorted((REPO / "examples" / "torch").glob("*.py"))


def _result_json(path):
    """A ``Result.to_dict()`` JSON file without its host wall time."""
    d = json.loads(Path(path).read_text())
    d.pop("wall_s")
    return d


# ------------------------------------------------------------ spec CLI
@pytest.mark.parametrize("spec_path", SPECS, ids=lambda p: p.stem)
def test_spec_cli_writes_the_reference_result(spec_path, tmp_path, capsys):
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    assert api_cli.main([str(spec_path), "--roundtrip-check", "--out",
                         str(got), "--quiet"]) == 0
    assert "roundtrip-check OK" in capsys.readouterr().out
    assert ref_api_cli.main([str(spec_path), "--roundtrip-check", "--out",
                             str(want), "--quiet"]) == 0
    assert _result_json(got) == _result_json(want)


def test_spec_cli_real_spec_needs_a_card_unless_asked(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ExperimentSpec.load(str(SPECS[0])).replace(learner="real")
    path = tmp_path / "real.json"
    spec.save(str(path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api_cli.main([str(path), "--quiet"])


# ----------------------------------------------------------- train CLI
SAVE_SPEC_ARGS = [
    [],
    ["--reduced", "--mode", "async", "--concurrency", "6",
     "--aggregation-goal", "3", "--rounds", "4", "--compression", "int8"],
    ["--surrogate", "--arch", "smollm-135m", "--local-epochs", "2",
     "--client-lr", "0.1", "--server-lr", "0.05", "--target-ppl", "175",
     "--seq-len", "32", "--batch-size", "4"],
]


@pytest.mark.parametrize("args", SAVE_SPEC_ARGS,
                         ids=["defaults", "reduced-async", "surrogate"])
def test_train_cli_save_spec_equals_the_reference(args, tmp_path):
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    assert train.main(args + ["--save-spec", str(got)]) == 0
    assert ref_train.main(args + ["--save-spec", str(want)]) == 0
    assert json.loads(got.read_text()) == json.loads(want.read_text())
    assert ExperimentSpec.load(str(got)).content_hash() == \
        RefSpec.load(str(want)).content_hash()


def test_reduced_model_ref_equals_the_reference():
    for arch in ("paper-charlm", "smollm-135m", "rwkv6-7b"):
        assert train.reduced_model_ref(arch).to_dict() == \
            ref_train.reduced_model_ref(arch).to_dict()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_train_cli_surrogate_gives_the_reference_summary(mode, tmp_path):
    args = ["--surrogate", "--mode", mode, "--concurrency", "50",
            "--rounds", "30"]
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    assert train.main(args + ["--json", str(got)]) == 0
    assert ref_train.main(args + ["--json", str(want)]) == 0
    assert json.loads(got.read_text()) == json.loads(want.read_text())


def test_train_cli_checkpoint_and_resume_give_the_reference_summary(
        tmp_path):
    """An engine snapshot every 10 rounds, then a resume from it: the
    resumed summary equals the uninterrupted run's and the reference's,
    and the reference resumes from the port's snapshot and the port from
    the reference's (the snapshot format is the reference's)."""
    args = ["--surrogate", "--mode", "async", "--concurrency", "40",
            "--rounds", "25"]
    out = {}
    for name, cli in (("port", train), ("ref", ref_train)):
        snap, j = tmp_path / f"{name}.snap", tmp_path / f"{name}.json"
        assert cli.main(args + ["--checkpoint", str(snap),
                                "--checkpoint-every", "10",
                                "--json", str(j)]) == 0
        out[name] = json.loads(j.read_text())
    assert out["port"] == out["ref"]
    for name, cli, snap in (("port", train, "port"), ("ref", ref_train,
                                                       "port"),
                            ("port-from-ref", train, "ref")):
        j = tmp_path / f"resumed-{name}.json"
        assert cli.main(["--resume", str(tmp_path / f"{snap}.snap"),
                         "--json", str(j)]) == 0
        assert json.loads(j.read_text()) == out["ref"], name


def test_train_cli_real_run_matches_the_reference(tmp_path, monkeypatch):
    """A reduced real run with --device cpu --json --ckpt, the port's
    learner started from the JAX learner's init: the summary as
    tests/test_torch_experiment.py holds it, the checkpoint's manifest
    equal to the JAX CLI's, and each leaf within a quarter of what the
    reference's two rounds moved it from the init: the int8 codec rounds
    a few entries of a delta one step apart in the two packages (2.2e-3 at
    most, in the LSTM's leaves, where every leaf moved 4e-2), so a
    checkpoint of the init or of an earlier round fails."""
    args = ["--reduced", "--concurrency", "4", "--aggregation-goal", "3",
            "--rounds", "2", "--compression", "int8"]
    ref_json, ref_ckpt = tmp_path / "ref.json", tmp_path / "ref_ckpt"
    ref_spec = tmp_path / "ref_spec.json"
    assert ref_train.main(args + ["--json", str(ref_json), "--ckpt",
                                  str(ref_ckpt)]) == 0
    assert ref_train.main(args + ["--save-spec", str(ref_spec)]) == 0
    ref_exp = RefExperiment(RefSpec.load(str(ref_spec)))
    init = jax.device_get(ref_exp.build_learner().params)

    class FromJaxInit(Experiment):
        def _make_learner(self):
            learner = super()._make_learner()
            cfg, spec = self.model_config, self.spec
            return RealLearner(cfg, spec.federated, spec.run,
                               learner.dataset,
                               max_client_steps=spec.max_client_steps,
                               device=learner.device, init_params=init)
    monkeypatch.setattr(train, "Experiment", FromJaxInit)
    got_json, got_ckpt = tmp_path / "port.json", tmp_path / "port_ckpt"
    assert train.main(args + ["--device", "cpu", "--json", str(got_json),
                              "--ckpt", str(got_ckpt)]) == 0
    got, want = json.loads(got_json.read_text()), \
        json.loads(ref_json.read_text())
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "perplexity":
            assert got[k] == pytest.approx(want[k], rel=1e-4)
        else:
            assert got[k] == want[k], k
    assert json.loads((got_ckpt / "manifest.json").read_text()) == \
        json.loads((ref_ckpt / "manifest.json").read_text())
    tree, meta = load_checkpoint(str(got_ckpt))
    assert meta == {"rounds": 2, "arch": "paper-charlm"}
    for k, v in ref_load(str(ref_ckpt))[0]["params"].items():
        moved = np.abs(v - np.asarray(init[k])).max()
        assert moved > 0, k
        np.testing.assert_allclose(tree["params"][k], v, rtol=0,
                                   atol=moved / 4, err_msg=k)


def test_train_cli_real_learner_on_an_unported_family_raises():
    """rwkv6-7b's RWKV6 has no ported loss yet (its WKV backward is
    ROADMAP queue 1 item 6): the real learner raises as the port's models
    do. (smollm-135m trains: tests/test_torch_train_transformer.py.)"""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                    "--concurrency", "2", "--rounds", "1"])


def test_train_cli_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--rounds", "1"])


# ---------------------------------------------------------- checkpoints
def _tiny_params():
    from repro.configs import get_config, reduced
    cfg = dataclasses.replace(
        reduced(get_config("paper-charlm"), layers=1, d_model=32, d_ff=32,
                vocab=128), lstm_hidden=32, max_context=8)
    params, _ = ref_get_model(cfg).init(jax.random.PRNGKey(3))
    return cfg, jax.device_get(params)


def test_checkpoints_cross_load_both_ways(tmp_path):
    from repro_torch.configs import model_config_from_dict
    jcfg, jparams = _tiny_params()
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    tparams = params_from_jax(jparams, "cpu", cfg)
    meta = {"rounds": 3, "arch": "paper-charlm"}
    ref_save(str(tmp_path / "jax"), {"params": jparams}, meta=meta)
    save_checkpoint(str(tmp_path / "port"), {"params": tparams}, meta=meta)
    assert json.loads((tmp_path / "jax" / "manifest.json").read_text()) == \
        json.loads((tmp_path / "port" / "manifest.json").read_text())
    # the port loads JAX's checkpoint, JAX loads the port's: bit-equal
    for load, path in ((load_checkpoint, "jax"), (ref_load, "port")):
        tree, got_meta = load(str(tmp_path / path))
        assert got_meta == meta
        assert sorted(tree["params"]) == sorted(jparams)
        for k, v in jparams.items():
            a = tree["params"][k]
            assert a.dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(a, np.asarray(v))
    # through weights.py the port's loaded params give JAX's forward
    tree, _ = load_checkpoint(str(tmp_path / "jax"))
    loaded = params_from_jax(tree["params"], "cpu", cfg)
    rng = np.random.default_rng(0)
    chars = rng.integers(0, cfg.char_vocab, (2, 6, cfg.max_word_len))
    labels = rng.integers(0, cfg.vocab_size, (2, 6))
    want = ref_get_model(jcfg).loss(jparams, {"chars": chars,
                                              "labels": labels})[0]
    with torch.no_grad():
        got = get_model(cfg).loss(loaded, {
            "chars": torch.as_tensor(chars), "labels":
            torch.as_tensor(labels)})[0]
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_checkpoint_keeps_nested_trees_dtypes_and_is_atomic(tmp_path):
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3)},
            "opt": {"step": torch.tensor(4, dtype=torch.int32),
                    "mu": {"w": np.ones((2, 3), np.float64)}}}
    save_checkpoint(str(tmp_path), tree, meta={"note": "x"})
    got, meta = load_checkpoint(str(tmp_path))
    assert meta == {"note": "x"}
    np.testing.assert_array_equal(got["params"]["w"],
                                  tree["params"]["w"].numpy())
    assert got["opt"]["step"].dtype == np.int32 and got["opt"]["step"] == 4
    assert got["opt"]["mu"]["w"].dtype == np.float64
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["arrays.npz", "manifest.json"]        # no temporary file left


def test_checkpoint_rejects_bfloat16(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        save_checkpoint(str(tmp_path), {"w": torch.ones(2,
                                                        dtype=torch.bfloat16)})


# ------------------------------------------------------------- examples
def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("twin", TWINS, ids=lambda p: p.stem)
def test_example_twin_imports_only_the_port(twin):
    ref = REPO / "examples" / twin.name
    assert ref.exists()                  # a twin of a reference example
    mods = {m.split(".")[0] for m in _imports(twin)}
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "repro"}, mods


def test_example_twins_are_the_three_the_roadmap_names():
    assert [p.stem for p in TWINS] == ["compare_sync_async", "green_advisor",
                                       "quickstart"]
