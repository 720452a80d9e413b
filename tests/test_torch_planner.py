"""plan_context: knob escalation, the port against the JAX package.

The cases of ``tests/test_planner.py``, each run through both packages'
planners with the same stubbed ``measure`` (a peak per set of escalated
knobs): the ladders, the chosen knobs and models, the trails and the
``describe()`` text must be equal. The port's default measure (one training
step per rung on the card) has no CPU form: it raises.
"""

import pytest

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import plan_context as jplan
from marlin_tpu.models.planner import _ladder as jladder

from marlin_tpu_torch import config_context
from marlin_tpu_torch.models import TransformerLM, plan_context
from marlin_tpu_torch.models import planner as tplanner
from marlin_tpu_torch.models.planner import GIB, ContextPlan, _ladder

KNOBS = ("remat", "loss_chunk", "mlp_chunk", "compute_dtype",
         "offload_residuals")


def _measure_table(table):
    """Fake measurer: peak by frozenset of escalated knob names."""
    def measure(m):
        key = frozenset(k for k in KNOBS if getattr(m, k) not in (None, False))
        return table[key], ""
    return measure


def _both(seq, budget, measure, **kw):
    """The port's plan and the JAX package's under one stub, checked equal."""
    small = dict(vocab=64, d_model=32, heads=2, layers=1)
    small.update(kw)
    got = plan_context(seq, TransformerLM(**small), hbm_budget=budget,
                       measure=measure)
    want = jplan(seq, JaxLM(**small), hbm_budget=budget, measure=measure)
    assert isinstance(got, ContextPlan)
    assert (got.knobs, got.peak_bytes, got.fits, got.budget_bytes, got.seq,
            got.trail) == (want.knobs, want.peak_bytes, want.fits,
                           want.budget_bytes, want.seq, want.trail)
    assert got.describe() == want.describe()
    assert {k: getattr(got.model, k) for k in KNOBS} == \
        {k: getattr(want.model, k) for k in KNOBS}
    return got


def test_ladder_is_cumulative_and_respects_preset_knobs():
    for kw in ({"vocab": 64, "d_model": 32, "heads": 2, "layers": 1},
               {"remat": True, "loss_chunk": 4096}):
        for seq in (100_000, 1000):
            assert _ladder(TransformerLM(**kw), seq) == \
                jladder(JaxLM(**kw), seq)
    lm = TransformerLM(vocab=64, d_model=32, heads=2, layers=1)
    rungs = _ladder(lm, seq=100_000)
    assert rungs[0] == {} and rungs[1] == {"remat": True}
    assert rungs[-1] == {"remat": True, "loss_chunk": 16384,
                         "mlp_chunk": 16384, "compute_dtype": "bfloat16",
                         "offload_residuals": True}
    assert _ladder(lm, seq=1000)[2]["loss_chunk"] == 1000


def test_plan_stops_at_first_fitting_rung():
    table = {frozenset(): 10 * GIB,
             frozenset({"remat"}): 6 * GIB,
             frozenset({"remat", "loss_chunk"}): 4 * GIB}
    plan = _both(50_000, 7 * GIB, _measure_table(table))
    assert plan.fits and plan.knobs == {"remat": True}
    assert plan.model.remat is True and plan.model.loss_chunk is None
    assert len(plan.trail) == 2
    plan0 = _both(50_000, 11 * GIB, _measure_table(table))
    assert plan0.fits and plan0.knobs == {} and plan0.model.remat is False


def test_plan_reports_no_fit_with_best_rung():
    table = {
        frozenset(): 40 * GIB,
        frozenset({"remat"}): 30 * GIB,
        frozenset({"remat", "loss_chunk"}): 28 * GIB,
        frozenset({"remat", "loss_chunk", "mlp_chunk"}): 27 * GIB,
        frozenset({"remat", "loss_chunk", "mlp_chunk", "compute_dtype"}):
            18 * GIB,
        frozenset(KNOBS): 19 * GIB,  # offload nets NEGATIVE
    }
    plan = _both(2_000_000, 15 * GIB, _measure_table(table))
    assert not plan.fits and plan.peak_bytes == 18 * GIB
    assert "offload_residuals" not in plan.knobs
    assert len(plan.trail) == 6 and "DOES NOT FIT" in plan.describe()


def test_budget_defaults_to_the_cards_usable_memory(monkeypatch):
    """The JAX package's budget is its measured or reserved HBM; the port's
    is the card's free plus cached memory, read only where there is a card:
    on the CPU the default budget raises, a given one or a stubbed source
    plans."""
    lm = TransformerLM(vocab=64, d_model=32, heads=2, layers=1)
    with config_context(device="cpu"):
        with pytest.raises(ValueError, match="CUDA"):
            plan_context(1000, lm, measure=lambda m: (GIB, ""))
        monkeypatch.setattr(tplanner, "usable_hbm_bytes",
                            lambda device=None: 3 * GIB)
        plan = plan_context(1000, lm, measure=lambda m: (2 * GIB, ""))
    assert plan.fits and plan.budget_bytes == 3 * GIB


def test_measure_failure_notes_do_not_abort_the_ladder():
    def measure(m):
        if not any(getattr(m, k) not in (None, False) for k in KNOBS):
            return None, "out of memory"  # the card's rung result
        return 2 * GIB, ""

    plan = _both(50_000, 4 * GIB, measure)
    assert plan.fits and plan.trail[0][1] is None
    assert "out of memory" in plan.trail[0][3]


def test_chips_and_topology_validation():
    lm = TransformerLM(vocab=64, d_model=32, heads=2, layers=1)
    with config_context(device="cpu"):
        with pytest.raises(ValueError, match="chips"):
            plan_context(1000, lm, chips=3, hbm_budget=GIB)
        with pytest.raises(ValueError, match="topology"):
            plan_context(1000, lm, topology_name="v5e:2x2", hbm_budget=GIB)
    # an explicit measure bypasses the ring check, as in the JAX package
    plan = plan_context(1000, lm, chips=3, hbm_budget=GIB,
                        measure=lambda m: (GIB // 2, ""))
    assert plan.fits


def test_default_measure_refuses_the_cpu():
    lm = TransformerLM(vocab=64, d_model=32, heads=2, layers=1)
    with config_context(device="cpu"):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            plan_context(1000, lm, hbm_budget=GIB)
