"""Search-driver tests with synthetic probe functions + end-to-end search."""

import pytest

from monte_carlo_retirement_tpu.engine.simulator import RetirementMonteCarloSimulator
from monte_carlo_retirement_tpu.search.driver import find_minimum_working_months
from tests.conftest import make_config


def test_search_finds_true_minimum_on_step_function():
    """Exact threshold recovery against a deterministic step at 37 months."""
    threshold = 37

    def probe(months):
        return [100.0 if m >= threshold else 0.0 for m in months]

    months, prob, curve = find_minimum_working_months(
        probe,
        starting_working_months=0,
        target_probability_pct=90.0,
        sim_count=10,
        verbose=False,
    )
    assert months == threshold
    assert prob >= 90.0
    assert len(curve) >= 1
    assert all("working_months" in p and "probability" in p for p in curve)


def test_search_verification_handles_non_monotone_probabilities():
    """An isolated earlier pass is found despite a later probability dip."""

    def probe(months):
        out = []
        for m in months:
            if m == 4:
                out.append(50.25)
            elif m >= 24:
                out.append(53.25)
            else:
                out.append(49.75)
        return out

    months, prob, _ = find_minimum_working_months(
        probe,
        starting_working_months=0,
        target_probability_pct=50.0,
        sim_count=400,
        verbose=False,
    )
    assert months == 4
    assert prob == pytest.approx(50.25)


def test_search_returns_minus_one_when_target_unreachable():
    calls = []

    def probe(months):
        calls.extend(months)
        return [40.0 + m / 1000.0 for m in months]

    months, best, curve = find_minimum_working_months(
        probe,
        starting_working_months=0,
        target_probability_pct=99.0,
        sim_count=100,
        verbose=False,
    )
    assert months == -1
    assert best == pytest.approx(40.0 + max(calls) / 1000.0)
    assert max(calls) == 70 * 12  # bracket cap: start + 70 years


def test_search_immediate_hit_at_start():
    def probe(months):
        return [95.0 for _ in months]

    months, prob, curve = find_minimum_working_months(
        probe,
        starting_working_months=18,
        target_probability_pct=90.0,
        sim_count=100,
        verbose=False,
    )
    assert months == 18
    assert prob == 95.0


def test_search_emits_progress_events():
    events = []

    def probe(months):
        return [100.0 if m >= 30 else 10.0 for m in months]

    months, _, _ = find_minimum_working_months(
        probe,
        starting_working_months=0,
        target_probability_pct=50.0,
        sim_count=100,
        verbose=False,
        progress_callback=events.append,
    )
    assert months == 30
    kinds = {e["type"] for e in events}
    assert "search_iter" in kinds
    assert "search_refining" in kinds
    iters = [e for e in events if e["type"] == "search_iter"]
    assert iters[0]["iteration"] == 1
    assert all(
        set(e) >= {"working_months", "working_years", "probability", "target",
                   "sim_count", "lo", "hi"}
        for e in iters
    )


def test_facade_search_uses_fake_engine_seam():
    """Monkeypatching run_monte_carlo_simulations reroutes the search probes
    (the reference's fake-engine test seam, preserved)."""
    threshold = 37
    cfg = make_config(
        target_probability=90.0,
        starting_working_months_search=0,
        num_simulations_search=10,
        seed=0,
    )
    sim = RetirementMonteCarloSimulator(cfg)

    from tests.conftest import fake_success_frame

    def fake_run(working_months: int, num_simulations: int):
        ok = working_months >= threshold
        return fake_success_frame(num_simulations if ok else 0, num_simulations)

    sim.run_monte_carlo_simulations = fake_run  # type: ignore[method-assign]
    months, prob, curve = sim.find_minimum_working_months(verbose=False)
    assert months == threshold
    assert prob >= 90.0


def test_end_to_end_search_on_engine():
    """Full search on the real engine converges and the final run meets the
    target within Monte Carlo error."""
    cfg = make_config(
        initial_balance=50_000.0,
        monthly_contribution=4_000.0,
        monthly_expenses=3_000.0,
        retirement_years=10,
        inv1_returns_mean=0.08,
        inv1_returns_volatility=0.12,
        inflation_rate_mean=0.03,
        inflation_rate_volatility=0.01,
        num_simulations_search=64,
        num_simulations_main=128,
        target_probability=85.0,
        seed=21,
    )
    sim = RetirementMonteCarloSimulator(cfg)
    months, prob, curve = sim.find_minimum_working_months(verbose=False)
    assert months > 0
    assert prob >= 85.0
    # Search stream hit the target at `months` and missed at the probed
    # points below it.
    tested = {p["working_months"]: p["probability"] for p in curve}
    assert tested[months] >= 85.0
    below = [p for m, p in tested.items() if m < months]
    assert all(p < 85.0 for p in below)


def test_search_with_nonzero_starting_months():
    """The ladder starts (and the cap anchors) at the configured start."""
    probed = []

    def probe(months):
        probed.extend(months)
        return [100.0 if m >= 30 else 10.0 for m in months]

    months, prob, _ = find_minimum_working_months(
        probe,
        starting_working_months=24,
        target_probability_pct=50.0,
        sim_count=100,
        verbose=False,
    )
    assert months == 30
    assert min(probed) == 24
    assert max(probed) <= 24 + 70 * 12


def test_search_target_met_exactly_at_cap():
    """A hit at the very last ladder point (start + 70y) is still found."""
    cap = 15 + 70 * 12

    def probe(months):
        return [100.0 if m >= cap else 0.0 for m in months]

    months, prob, _ = find_minimum_working_months(
        probe,
        starting_working_months=15,
        target_probability_pct=90.0,
        sim_count=10_000,  # tiny margin -> verification region stays small
        verbose=False,
    )
    assert months == cap
    assert prob == 100.0


def test_probe_rejects_short_horizon_and_negative_months():
    """Guards against silently-truncated accumulation phases and negative
    candidates (the scan horizon must cover every candidate)."""
    from monte_carlo_retirement_tpu.engine.runner import Engine

    engine = Engine(make_config(retirement_years=1, seed=3))
    with pytest.raises(ValueError, match="below the largest candidate"):
        engine.probe([600], 8, horizon_months=300)
    with pytest.raises(ValueError, match=">= 0"):
        engine.probe([-1], 8)
    with pytest.raises(ValueError, match="working_months"):
        engine.run(-12, 8)
    with pytest.raises(ValueError, match="seed stream"):
        engine._key("serach")
