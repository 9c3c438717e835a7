"""Config validation: every bound, type and cross-field rule of the schema.

The schema table below is the contract the reference's config files and
the API clients rely on (reference backend/config.py:12-126 plus this
project's extensions). Each bound must reject a value just past it with a
ValueError that names the field, and accept the bound itself when the bound
is inclusive.
"""

import math

import pytest

from monte_carlo_retirement_tpu.config import Config, ConfigurationError
from tests.conftest import base_config_dict

STREAM = {
    "name": "P", "monthly_amount_today": 500.0, "start_at_age": 60.0,
    "duration_years": 5, "inflation_indexed": True, "tax_rate": 0.1,
}
NESTED = {
    "spending_guardrails": {"upper_wr_pct": 6.0, "lower_wr_pct": 3.0},
    "market_crashes": {"frequency_per_year": 1.0, "mean_drop_pct": 20.0},
    "longevity": {"mode_age": 86.0},
}

# (dotted field, bound kind, bound value)
BOUNDS = [
    ("initial_balance", "ge", 0.0),
    ("monthly_contribution", "ge", 0.0),
    ("contribution_growth_rate_annual", "ge", 0.0),
    ("monthly_expenses", "ge", 0.0),
    ("current_age", "ge", 0.0),
    ("current_age", "le", 120.0),
    ("retirement_years", "gt", 0),
    ("allocation_inv1_pct", "ge", 0.0),
    ("allocation_inv1_pct", "le", 1.0),
    ("allocation_inv1_final_pct", "ge", 0.0),
    ("allocation_inv1_final_pct", "le", 1.0),
    ("inv1_returns_mean", "gt", -1.0),
    ("inv1_returns_volatility", "ge", 0.0),
    ("inv1_expense_ratio_annual", "ge", 0.0),
    ("inv1_expense_ratio_annual", "lt", 1.0),
    ("inv1_annual_tax_on_gains_rate", "ge", 0.0),
    ("inv1_annual_tax_on_gains_rate", "le", 1.0),
    ("inv1_realized_gains_tax_rate", "ge", 0.0),
    ("inv1_realized_gains_tax_rate", "le", 1.0),
    ("inv2_premium_over_inflation_mean", "gt", -1.0),
    ("inv2_premium_over_inflation_volatility", "ge", 0.0),
    ("inv2_expense_ratio_annual", "ge", 0.0),
    ("inv2_expense_ratio_annual", "lt", 1.0),
    ("inv2_annual_tax_on_gains_rate", "ge", 0.0),
    ("inv2_annual_tax_on_gains_rate", "le", 1.0),
    ("inv2_realized_gains_tax_rate", "ge", 0.0),
    ("inv2_realized_gains_tax_rate", "le", 1.0),
    ("inflation_rate_mean", "gt", -1.0),
    ("inflation_rate_volatility", "ge", 0.0),
    ("equity_inflation_correlation", "ge", -1.0),
    ("equity_inflation_correlation", "le", 1.0),
    ("num_simulations_main", "gt", 0),
    ("num_simulations_search", "gt", 0),
    ("target_probability", "ge", 0.0),
    ("target_probability", "le", 100.0),
    ("starting_working_months_search", "ge", 0),
    ("seed", "ge", 0),
    ("num_processes", "ge", 1),
    ("other_income_streams.monthly_amount_today", "ge", 0.0),
    ("other_income_streams.start_at_age", "ge", 0.0),
    ("other_income_streams.start_at_age", "le", 120.0),
    ("other_income_streams.duration_years", "ge", 0),
    ("other_income_streams.tax_rate", "ge", 0.0),
    ("other_income_streams.tax_rate", "le", 1.0),
    ("spending_guardrails.upper_wr_pct", "gt", 0.0),
    ("spending_guardrails.upper_wr_pct", "le", 100.0),
    ("spending_guardrails.lower_wr_pct", "ge", 0.0),
    ("spending_guardrails.adjustment_pct", "gt", 0.0),
    ("spending_guardrails.adjustment_pct", "le", 50.0),
    ("spending_guardrails.floor_pct", "ge", 0.0),
    ("spending_guardrails.floor_pct", "le", 100.0),
    ("spending_guardrails.cap_pct", "ge", 100.0),
    ("market_crashes.frequency_per_year", "ge", 0.0),
    ("market_crashes.frequency_per_year", "le", 12.0),
    ("market_crashes.mean_drop_pct", "gt", 0.0),
    ("market_crashes.mean_drop_pct", "lt", 100.0),
    ("market_crashes.size_volatility", "ge", 0.0),
    ("market_crashes.size_volatility", "le", 2.0),
    ("market_crashes.inv2_beta", "ge", 0.0),
    ("market_crashes.inv2_beta", "le", 1.0),
    ("longevity.mode_age", "gt", 0.0),
    ("longevity.mode_age", "le", 120.0),
    ("longevity.dispersion_years", "ge", 1.0),
    ("longevity.dispersion_years", "le", 30.0),
    ("longevity.max_age", "gt", 0.0),
    ("longevity.max_age", "le", 130.0),
]

INT_FIELDS = {
    "retirement_years", "num_simulations_main", "num_simulations_search",
    "starting_working_months_search", "seed", "num_processes",
    "other_income_streams.duration_years",
}


def _with(field, value):
    data = base_config_dict(other_income_streams=[dict(STREAM)], **{
        k: dict(v) for k, v in NESTED.items()
    })
    # Keep cross-field rules satisfied so only the bound under test binds.
    data["longevity"]["max_age"] = 125.0
    head, _, leaf = field.partition(".")
    if not leaf:
        data[head] = value
    elif head == "other_income_streams":
        data[head][0][leaf] = value
    else:
        data[head][leaf] = value
        if field == "spending_guardrails.lower_wr_pct" and value >= 6.0:
            data[head]["upper_wr_pct"] = value + 1.0
        if field == "spending_guardrails.upper_wr_pct":
            data[head]["lower_wr_pct"] = 0.0
        if field == "longevity.mode_age":
            data[head]["max_age"] = 130.0
        if field == "longevity.max_age":
            data[head]["mode_age"] = min(value, 120.0) / 2 or 1.0
    return data


def _past(kind, bound, is_int):
    step = 1 if is_int else 1e-6 * max(1.0, abs(bound))
    return bound - step if kind in ("ge", "gt") else bound + step


@pytest.mark.parametrize("field,kind,bound", BOUNDS,
                         ids=[f"{f}-{k}" for f, k, _ in BOUNDS])
def test_each_bound_rejects_and_inclusive_bound_accepts(field, kind, bound):
    is_int = field in INT_FIELDS
    bad = _past(kind, bound, is_int) if kind in ("ge", "le") else bound
    with pytest.raises(ValueError, match=field.rsplit(".", 1)[-1]) as info:
        Config(**_with(field, bad))
    assert isinstance(info.value, ConfigurationError)
    if kind in ("ge", "le"):
        Config(**_with(field, bound))
    else:
        inside = bound + (1 if is_int else 1e-6) * (1 if kind == "gt" else -1)
        Config(**_with(field, inside))


@pytest.mark.parametrize(
    "field,value",
    [
        ("monthly_expenses", "not-a-number"),
        ("monthly_expenses", None),
        ("monthly_expenses", [1.0]),
        ("retirement_years", 2.5),
        ("seed", True),
        ("antithetic", "maybe"),
        ("scenario", 5),
        ("other_income_streams", {"name": "not a list"}),
        ("market_crashes", 3.0),
    ],
)
def test_wrong_types_reject(field, value):
    data = base_config_dict()
    data[field] = value
    with pytest.raises(ConfigurationError, match=field if field != "scenario"
                       else "Nickname"):
        Config(**data)


def test_required_fields_reject_when_missing():
    for field in ("initial_balance", "monthly_expenses", "current_age",
                  "target_probability"):
        data = base_config_dict()
        data.pop(field)
        with pytest.raises(ConfigurationError, match=f"{field}\n  Field required"):
            Config(**data)


def test_cross_field_rules_reject():
    bad = base_config_dict(
        spending_guardrails={"upper_wr_pct": 4.0, "lower_wr_pct": 4.0}
    )
    with pytest.raises(ConfigurationError, match="must be below upper"):
        Config(**bad)
    bad = base_config_dict(longevity={"mode_age": 90.0, "max_age": 90.0})
    with pytest.raises(ConfigurationError, match="max_age.*exceed"):
        Config(**bad)


def test_lax_conversions_and_unknown_keys():
    cfg = Config(**base_config_dict(
        retirement_years=10.0, initial_balance="1000", antithetic="true",
        num_processes=None, unknown_key="ignored",
    ))
    assert cfg.retirement_years == 10 and isinstance(cfg.retirement_years, int)
    assert cfg.initial_balance == 1000.0 and cfg.antithetic is True
    assert cfg.num_processes is None
    assert not hasattr(cfg, "unknown_key")


def test_assignment_is_validated():
    cfg = Config(**base_config_dict())
    cfg.monthly_expenses = 2_500
    assert cfg.monthly_expenses == 2_500.0
    with pytest.raises(ConfigurationError, match="monthly_expenses"):
        cfg.monthly_expenses = -1.0
    assert cfg.monthly_expenses == 2_500.0


def test_dump_copy_and_schema_round_trip():
    cfg = Config(**base_config_dict(
        other_income_streams=[dict(STREAM)], **{k: dict(v) for k, v in NESTED.items()}
    ))
    assert Config(**cfg.model_dump(by_alias=True)) == cfg
    assert cfg.model_dump(by_alias=True)["scenario"] == cfg.Nickname
    assert Config(**cfg.model_dump()) == cfg
    deep = cfg.model_copy(deep=True)
    deep.spending_guardrails.upper_wr_pct = 7.0
    assert cfg.spending_guardrails.upper_wr_pct == 6.0
    upd = cfg.model_copy(update={"other_income_streams": []})
    assert upd.other_income_streams == [] and cfg.other_income_streams
    schema = Config.model_json_schema(ref_template="#/components/schemas/{model}")
    assert schema["properties"]["initial_balance"]["minimum"] == 0
    assert "initial_balance" in schema["required"]
    assert set(schema["$defs"]) == {
        "OtherIncomeStreamConfig", "SpendingGuardrailsConfig",
        "MarketCrashConfig", "LongevityConfig",
    }
    assert not math.isnan(cfg.allocation_inv2_pct)
