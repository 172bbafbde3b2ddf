"""The port's Green advisor (paper C4) and carbon predictor (§5.3, Figs.
8-9) against the reference package's on a small grid: the advisor runs
surrogate specs only, so every recommendation, its order, the Pareto
front, the ``feasible=False`` fallback and the predictor's fit are equal
bit for bit."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import RunConfig as JRun  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.advisor import GreenAdvisor as JAdvisor  # noqa: E402
from repro.core.predictor import CarbonPredictor as JPredictor  # noqa: E402
from repro.core.predictor import fit_linear as jfit_linear  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core.advisor import (DEFAULT_GRID, GreenAdvisor,  # noqa: E402
                                      Recommendation)
from repro_torch.core.predictor import CarbonPredictor, fit_linear  # noqa: E402

# tests/test_advisor.py's grid
GRID = dict(mode=("sync",), concurrency=(50, 200),
            local_epochs=(1, 10), compression=("none", "int8"))
TARGET = 175.0


@pytest.fixture(scope="module")
def advisors():
    return (GreenAdvisor(get_config("paper-charlm"),
                         RunConfig(target_perplexity=TARGET)),
            JAdvisor(jget_config("paper-charlm"),
                     JRun(target_perplexity=TARGET)))


def _plain(recs):
    """Recommendations as plain values (the two packages' classes are
    distinct types)."""
    return [(dataclasses.asdict(r.fed), r.carbon_kg, r.duration_h,
             r.reached_target, r.rounds, r.feasible, r.why()) for r in recs]


def test_search_and_recommend_equal_the_reference(advisors):
    port, ref = advisors
    recs = port.search(grid=GRID)
    assert all(isinstance(r, Recommendation) for r in recs)
    assert _plain(recs) == _plain(ref.search(grid=GRID))
    assert _plain([port.recommend(grid=GRID)]) == \
        _plain([ref.recommend(grid=GRID)])
    assert recs[0].reached_target and recs[0].feasible


@pytest.mark.parametrize("share", [0.6, 0.01])
def test_deadline_search_equals_the_reference(advisors, share):
    """A deadline some configs meet, and one none does: then every
    candidate comes back carbon-sorted and marked ``feasible=False``."""
    port, ref = advisors
    limit = port.search(grid=GRID)[0].duration_h * share
    got = port.search(grid=GRID, max_hours=limit)
    assert _plain(got) == _plain(ref.search(grid=GRID, max_hours=limit))
    if share < 0.1:
        assert not any(r.feasible for r in got)
        assert "[INFEASIBLE]" in got[0].why()


def test_pareto_equals_the_reference(advisors):
    port, ref = advisors
    front = GreenAdvisor.pareto(port.search(grid=GRID))
    assert len(front) >= 1
    assert _plain(front) == _plain(JAdvisor.pareto(ref.search(grid=GRID)))


def test_default_grid_is_the_reference_recipe():
    from repro.core.advisor import DEFAULT_GRID as JGRID
    assert DEFAULT_GRID == JGRID


def test_predictor_equals_the_reference():
    conc, rounds = [50, 100, 200, 400], [300.0, 180.0, 120.0, 90.0]
    carbon = [1.1, 1.4, 2.2, 3.9]
    for mode in ("sync", "async"):
        got = CarbonPredictor.from_measurements(mode, conc, rounds, carbon)
        want = JPredictor.from_measurements(mode, conc, rounds, carbon)
        assert dataclasses.asdict(got.fit) == dataclasses.asdict(want.fit)
        assert got.predict_kg(300, 100.0) == want.predict_kg(300, 100.0)
    exact = fit_linear([1.0, 2.0, 3.0], [3.0, 5.0, 7.0])
    assert exact.r2 == pytest.approx(1.0)
    assert dataclasses.asdict(exact) == \
        dataclasses.asdict(jfit_linear([1.0, 2.0, 3.0], [3.0, 5.0, 7.0]))
