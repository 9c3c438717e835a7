"""Configuration schema for retirement Monte Carlo scenarios.

The JSON schema is wire-compatible with the reference project's config files
(reference: backend/config.py:12-126): the same ``config.json`` documents load
unchanged. Validation bounds, aliases, derived fields and soft warnings match
the reference so that host layers (CLI/server/frontend) interoperate.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("mcrt.config")


class ConfigurationError(ValueError):
    """A configuration could not be read, parsed or validated."""


_REQUIRED = object()


@dataclass(frozen=True)
class Field:
    """One schema field: its kind (float, int, bool, str, a nested model, or
    a list of one), default, bounds and description."""

    kind: Any
    default: Any = _REQUIRED
    ge: Optional[float] = None
    gt: Optional[float] = None
    le: Optional[float] = None
    lt: Optional[float] = None
    optional: bool = False  # None is a valid value
    alias: Optional[str] = None
    description: str = ""
    default_factory: Optional[Callable[[], Any]] = None
    list_of: bool = False

    def fresh_default(self):
        return self.default_factory() if self.default_factory else self.default


_TRUE = {"true", "1", "yes", "on", "t", "y"}
_FALSE = {"false", "0", "no", "off", "f", "n"}


def _coerce(kind, value):
    """Value -> kind with the lax conversions JSON inputs need; raises
    ValueError with the reason."""
    if isinstance(kind, type) and issubclass(kind, _Model):
        if isinstance(value, kind):
            return copy.deepcopy(value)
        if isinstance(value, dict):
            return kind(**value)
        raise ValueError("Input should be an object")
    if kind is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
            return value.strip().lower() in _TRUE
        raise ValueError("Input should be a valid boolean")
    if kind is str:
        if isinstance(value, str):
            return value
        raise ValueError("Input should be a valid string")
    if isinstance(value, bool) or value is None:
        raise ValueError(f"Input should be a valid {kind.__name__}")
    if isinstance(value, str):
        try:
            value = float(value.strip())
        except ValueError:
            raise ValueError(
                f"Input should be a valid number, unable to parse string "
                f"as {kind.__name__}"
            ) from None
    if not isinstance(value, (int, float)):
        raise ValueError(f"Input should be a valid {kind.__name__}")
    if kind is int:
        if isinstance(value, float) and not (
            math.isfinite(value) and value == int(value)
        ):
            raise ValueError("Input should be a valid integer")
        return int(value)
    return float(value)


def _check_bounds(spec: Field, value) -> None:
    for op, bound, ok in (
        ("greater than or equal to", spec.ge, lambda v, b: v >= b),
        ("greater than", spec.gt, lambda v, b: v > b),
        ("less than or equal to", spec.le, lambda v, b: v <= b),
        ("less than", spec.lt, lambda v, b: v < b),
    ):
        if bound is not None and not ok(value, bound):
            raise ValueError(f"Input should be {op} {bound:g}")


def _validate_field(spec: Field, value):
    if value is None:
        if spec.optional:
            return None
        raise ValueError(
            f"Input should be a valid {getattr(spec.kind, '__name__', spec.kind)}"
        )
    if spec.list_of:
        if not isinstance(value, (list, tuple)):
            raise ValueError("Input should be a valid list")
        return [_coerce(spec.kind, v) for v in value]
    value = _coerce(spec.kind, value)
    if spec.kind in (int, float):
        _check_bounds(spec, value)
    return value


class _Model:
    """Stdlib schema model checked from its ``FIELDS`` table.

    Keeps the method names the rest of the package calls (``model_copy``,
    ``model_dump``, ``model_dump_json``, ``model_json_schema``). Unknown keys
    are ignored; every invalid field is reported in one
    :class:`ConfigurationError`; assignments are validated too."""

    FIELDS: Dict[str, Field] = {}

    def __init__(self, **data: Any):
        errors: List[str] = []
        values: Dict[str, Any] = {}
        for name, spec in self.FIELDS.items():
            if spec.alias is not None and spec.alias in data:
                raw = data[spec.alias]
            elif name in data:
                raw = data[name]
            elif spec.default is _REQUIRED and spec.default_factory is None:
                errors.append(f"{name}\n  Field required")
                continue
            else:
                values[name] = spec.fresh_default()
                continue
            try:
                values[name] = _validate_field(spec, raw)
            except ValueError as exc:
                errors.append(f"{name}\n  {exc} [input_value={raw!r}]")
        if not errors:
            try:
                self._check(values)
            except ValueError as exc:
                errors.append(str(exc))
        if errors:
            raise ConfigurationError(
                f"{len(errors)} validation error"
                f"{'s' if len(errors) > 1 else ''} for "
                f"{type(self).__name__}\n" + "\n".join(errors)
            )
        for name, value in values.items():
            object.__setattr__(self, name, value)
        self._warn(values)

    def _check(self, values: Dict[str, Any]) -> None:
        """Cross-field rules; raise ValueError naming the fields."""

    def _warn(self, values: Dict[str, Any]) -> None:
        """Soft checks on a valid model: log, never raise."""

    def __setattr__(self, name: str, value: Any) -> None:
        spec = self.FIELDS.get(name)
        if spec is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}"
            )
        try:
            value = _validate_field(spec, value)
            self._check({**self.__dict__, name: value})
        except ValueError as exc:
            raise ConfigurationError(f"{name}\n  {exc}") from None
        object.__setattr__(self, name, value)

    def __eq__(self, other: Any) -> bool:
        return type(other) is type(self) and self.model_dump() == other.model_dump()

    __hash__ = None  # mutable, like the models it replaces

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in self.FIELDS)
        return f"{type(self).__name__}({inner})"

    def model_dump(self, by_alias: bool = False, mode: str = "python") -> Dict[str, Any]:
        del mode  # every value is already JSON-compatible
        out: Dict[str, Any] = {}
        for name, spec in self.FIELDS.items():
            value = getattr(self, name)
            if isinstance(value, _Model):
                value = value.model_dump(by_alias=by_alias)
            elif isinstance(value, list):
                value = [
                    v.model_dump(by_alias=by_alias) if isinstance(v, _Model)
                    else v
                    for v in value
                ]
            out[spec.alias if by_alias and spec.alias else name] = value
        return out

    def model_dump_json(self, by_alias: bool = False) -> str:
        return json.dumps(self.model_dump(by_alias=by_alias))

    def model_copy(self, update: Optional[Dict[str, Any]] = None,
                   deep: bool = False):
        """A copy; ``update`` values are set without validation."""
        new = copy.deepcopy(self) if deep else copy.copy(self)
        for name, value in (update or {}).items():
            object.__setattr__(new, name, value)
        return new

    @classmethod
    def model_json_schema(
        cls, ref_template: str = "#/$defs/{model}"
    ) -> Dict[str, Any]:
        """JSON Schema of the model; nested models go under ``$defs``."""
        defs: Dict[str, Any] = {}
        schema = cls._schema(ref_template, defs)
        if defs:
            schema["$defs"] = defs
        return schema

    @classmethod
    def _schema(cls, ref_template: str, defs: Dict[str, Any]) -> Dict[str, Any]:
        json_types = {float: "number", int: "integer", bool: "boolean",
                      str: "string"}
        props: Dict[str, Any] = {}
        required: List[str] = []
        for name, spec in cls.FIELDS.items():
            key = spec.alias or name
            if isinstance(spec.kind, type) and issubclass(spec.kind, _Model):
                if spec.kind.__name__ not in defs:
                    defs[spec.kind.__name__] = {}
                    defs[spec.kind.__name__] = spec.kind._schema(
                        ref_template, defs
                    )
                item: Dict[str, Any] = {
                    "$ref": ref_template.format(model=spec.kind.__name__)
                }
            else:
                item = {"type": json_types[spec.kind]}
                for bound in ("ge", "gt", "le", "lt"):
                    value = getattr(spec, bound)
                    if value is not None:
                        item[{"ge": "minimum", "gt": "exclusiveMinimum",
                              "le": "maximum", "lt": "exclusiveMaximum"}[
                            bound]] = value
            if spec.list_of:
                item = {"type": "array", "items": item}
            if spec.optional:
                item = {"anyOf": [item, {"type": "null"}]}
            if spec.description:
                item["description"] = spec.description
            default = spec.fresh_default()
            if default is _REQUIRED:
                required.append(key)
            elif not isinstance(default, _Model):
                item["default"] = default
            props[key] = item
        schema: Dict[str, Any] = {
            "title": cls.__name__, "type": "object", "properties": props,
        }
        if cls.__doc__:
            schema["description"] = " ".join(cls.__doc__.split())
        if required:
            schema["required"] = required
        return schema


class OtherIncomeStreamConfig(_Model):
    """One additional retirement income stream (pension, rent, annuity...).

    Payment timing: the stream is *eligible* from ``start_at_age`` but only
    pays during retirement, i.e. payments begin at
    ``max(retirement_age, start_at_age)`` (reference: backend/config.py:23-32).
    """

    FIELDS = {
        "name": Field(str, description="Display name for this income stream."),
        "monthly_amount_today": Field(
            float, ge=0,
            description="Monthly amount in T=0 (today's) real dollars.",
        ),
        "start_at_age": Field(
            float, ge=0, le=120,
            description="Age at which the stream becomes eligible.",
        ),
        "duration_years": Field(
            int, None, ge=0, optional=True,
            description="Years of payments once started; None means indefinitely.",
        ),
        "inflation_indexed": Field(
            bool, True,
            description=(
                "True: tracks the price level from T=0. False: nominal amount "
                "is frozen at its value on the first payment date."
            ),
        ),
        "tax_rate": Field(float, ge=0.0, le=1.0, description="Tax on this income."),
    }


class SpendingGuardrailsConfig(_Model):
    """Dynamic spending rule (extension — the reference's retirement
    spending is a fixed real amount): at the start of each retirement year
    after the first, the planned-spending multiplier adjusts when the
    planned withdrawal rate crosses a guardrail, Guyton-Klinger style.

    Precise semantics (both kernels + the test oracle implement this):
      * a per-path multiplier ``s`` starts at 1.0 (year 0 spends the plan,
        so first-year statistics are unchanged);
      * at retirement month indices 12, 24, ... (before that month's
        income/withdrawal), WR = 12 * monthly_expenses * s * price_level /
        balance-entering-the-month;
      * WR above ``upper_wr_pct`` cuts s by ``adjustment_pct`` percent; WR
        below ``lower_wr_pct`` raises it by the same; s then clamps to
        [floor_pct, cap_pct] of the original plan.
    """

    FIELDS = {
        "upper_wr_pct": Field(
            float, gt=0.0, le=100.0,
            description="Cut spending when the planned WR exceeds this percent.",
        ),
        "lower_wr_pct": Field(
            float, ge=0.0,
            description="Raise spending when the planned WR falls below this.",
        ),
        "adjustment_pct": Field(
            float, 10.0, gt=0.0, le=50.0,
            description="Step size per trigger, percent.",
        ),
        "floor_pct": Field(
            float, 50.0, ge=0.0, le=100.0,
            description="Spending floor as a percent of the original plan.",
        ),
        "cap_pct": Field(
            float, 200.0, ge=100.0,
            description="Spending cap as a percent of the original plan.",
        ),
    }

    def _check(self, values: Dict[str, Any]) -> None:
        lower, upper = values["lower_wr_pct"], values["upper_wr_pct"]
        if lower >= upper:
            raise ValueError(
                f"lower_wr_pct\n  lower_wr_pct ({lower}) must be below "
                f"upper_wr_pct ({upper})"
            )


class MarketCrashConfig(_Model):
    """Jump-diffusion crash risk (extension — the reference's returns are
    pure lognormal): in any month, with probability ``frequency_per_year/12``
    a market crash multiplies asset 1's gross return by a lognormal jump
    factor exp(J), J ~ Normal(log(1 - mean_drop_pct/100), size_volatility).
    Asset 2 takes ``inv2_beta`` of the same log jump. The monthly drift is
    compensated so E[annual gross] still equals 1 + configured mean — crashes
    reshape the return distribution (fat left tail, sequence-of-returns
    risk) without changing its mean, keeping the config's mean fields honest.

    Precise semantics (both kernels + the test oracle implement this):
      * per (path, month) draw one uniform u and one standard normal z from
        a stream independent of the base shocks (the base draws are
        bit-identical with the rule on or off);
      * J = log(1 - mean_drop_pct/100) + size_volatility * z when
        u < frequency_per_year/12, else 0;
      * gross1 *= exp(J - c1), gross2 *= exp(inv2_beta * J - c2) where
        c_a = log(1 - p + p * exp(a*mu_J + (a*sigma_J)^2 / 2)) is the exact
        compensator (a=1 for asset 1, a=inv2_beta for asset 2); inflation
        is untouched.
    """

    FIELDS = {
        "frequency_per_year": Field(
            float, ge=0.0, le=12.0,
            description=(
                "Expected crashes per year; the monthly Bernoulli probability "
                "is this / 12 (so 12 means a crash every month)."
            ),
        ),
        "mean_drop_pct": Field(
            float, gt=0.0, lt=100.0,
            description="Median crash size as a percent drop (20 => x0.80).",
        ),
        "size_volatility": Field(
            float, 0.0, ge=0.0, le=2.0,
            description=(
                "Dispersion of the log jump size (0 = every crash is exactly "
                "the median drop)."
            ),
        ),
        "inv2_beta": Field(
            float, 0.0, ge=0.0, le=1.0,
            description=(
                "Fraction of the log jump applied to asset 2 (0 = crashes hit "
                "asset 1 only; 1 = both assets crash identically)."
            ),
        ),
    }


class LongevityConfig(_Model):
    """Stochastic lifespan (extension — the reference funds a fixed
    ``retirement_years`` horizon): each path draws a remaining lifetime at
    the retirement date from a Gompertz law conditioned on having survived
    to that age, and success becomes "the money outlasted the owner".

    Precise semantics (both kernels + the test oracle implement this):
      * per path draw ONE uniform u from a stream disjoint from the base
        shocks (the base draws are bit-identical with the rule on or off);
      * remaining lifetime in months at retirement age ``x_ret``:
        ``t = 12*b * ln(1 - ln(u) * exp((mode_age - x_ret)/b))`` — the exact
        Gompertz inverse-survival with dispersion ``b`` — capped at
        ``(max_age - x_ret) * 12``; small u = long life, so antithetic
        pairing (u -> 1-u) anti-correlates lifespans;
      * the path spends normally through retirement months ``k <= t`` and
        then stops: expenses and income streams end with the owner, while
        the estate stays invested (growth, rebalancing and annual taxes
        continue) so the final balance is the bequest at the plan horizon;
      * ruin can only happen while the owner is alive — a path that would
        have run out of money after death counts as a success — and
        withdrawal-rate observations exist only for fully-lived years
        (later years are NaN, like the reference's post-ruin years).

    The same uniform is reused across working-month candidates (CRN), so a
    candidate that retires later samples the SAME longevity percentile
    conditioned on the later age — search curves stay smooth.
    """

    FIELDS = {
        "mode_age": Field(
            float, gt=0.0, le=120.0,
            description=(
                "Gompertz modal age at death (the most likely age to die; "
                "~86-90 for current annuitant tables)."
            ),
        ),
        "dispersion_years": Field(
            float, 10.0, ge=1.0, le=30.0,
            description=(
                "Gompertz dispersion b in years (~9-11 for human mortality; "
                "larger = more lifespan uncertainty)."
            ),
        ),
        "max_age": Field(
            float, 120.0, gt=0.0, le=130.0,
            description="Hard cap: lifetimes truncate at this age.",
        ),
    }

    def _check(self, values: Dict[str, Any]) -> None:
        mode, cap = values["mode_age"], values["max_age"]
        if cap <= mode:
            raise ValueError(
                f"max_age\n  max_age ({cap}) must exceed mode_age ({mode})"
            )


class Config(_Model):
    """Scenario configuration (same JSON schema as the reference config.json)."""

    FIELDS = {
        "Nickname": Field(
            str, "DefaultScenario", alias="scenario",
            description="Scenario nickname.",
        ),
        # Household economics
        "initial_balance": Field(float, ge=0),
        "monthly_contribution": Field(float, ge=0),
        "contribution_growth_rate_annual": Field(float, 0.0, ge=0),
        "monthly_expenses": Field(
            float, ge=0, description="Monthly spending in T=0 real dollars."
        ),
        "current_age": Field(float, ge=0, le=120),
        "retirement_years": Field(int, gt=0),
        # Asset 1 ("equity-like"): arithmetic annual mean/vol, with either an
        # annual mark-to-market gains tax or a realized-gains tax on sales.
        "allocation_inv1_pct": Field(float, ge=0.0, le=1.0),
        # Glide path (extension — the reference holds allocation fixed): when
        # set, the rebalance/contribution target for asset 1 moves LINEARLY
        # in time from allocation_inv1_pct at T=0 to this value at
        # retirement (month `working_months`), then holds through
        # retirement. None (the default) keeps the reference's
        # constant-allocation behavior bit for bit. The T=0 portfolio is
        # always split at allocation_inv1_pct.
        "allocation_inv1_final_pct": Field(
            float, None, ge=0.0, le=1.0, optional=True
        ),
        "inv1_returns_mean": Field(float, gt=-1.0),
        "inv1_returns_volatility": Field(float, ge=0.0),
        # Annual expense ratio (extension — the reference's returns carry no
        # fees): a continuous drag deducted inside the fund, i.e. every
        # monthly gross factor is multiplied by (1 - ratio)^(1/12), making
        # the realized arithmetic mean (1 + mean)(1 - ratio) - 1. Folded into
        # the lognormal drift host-side, so the kernels are untouched and
        # 0.0 (the default) is bit-identical to the reference's fee-free
        # model.
        "inv1_expense_ratio_annual": Field(float, 0.0, ge=0.0, lt=1.0),
        "inv1_annual_tax_on_gains_rate": Field(float, ge=0.0, le=1.0),
        "inv1_realized_gains_tax_rate": Field(float, 0.0, ge=0.0, le=1.0),
        "inv1_use_realized_gains_tax_system": Field(bool, False),
        # Asset 2 ("inflation-linked"): returns are inflation times a premium.
        "inv2_premium_over_inflation_mean": Field(float, gt=-1.0),
        "inv2_premium_over_inflation_volatility": Field(float, ge=0.0),
        # Annual expense ratio on asset 2 (see inv1_expense_ratio_annual);
        # applied to the whole asset return (inflation x premium x (1-ratio)
        # per year), folded into the premium drift.
        "inv2_expense_ratio_annual": Field(float, 0.0, ge=0.0, lt=1.0),
        "inv2_annual_tax_on_gains_rate": Field(float, ge=0.0, le=1.0),
        "inv2_realized_gains_tax_rate": Field(float, 0.0, ge=0.0, le=1.0),
        "inv2_use_realized_gains_tax_system": Field(bool, True),
        # Inflation process and its coupling to equity shocks.
        "inflation_rate_mean": Field(float, gt=-1.0),
        "inflation_rate_volatility": Field(float, ge=0.0),
        "equity_inflation_correlation": Field(
            float, 0.0, ge=-1.0, le=1.0,
            description=(
                "Correlation of equity log-returns with inflation log-rates."
            ),
        ),
        # Simulation controls
        "num_simulations_main": Field(int, gt=0),
        "num_simulations_search": Field(int, gt=0),
        "target_probability": Field(float, ge=0.0, le=100.0),
        "starting_working_months_search": Field(int, ge=0),
        "seed": Field(int, None, ge=0, optional=True),
        # Variance reduction (extension — the reference has no analog): pair
        # each shock sequence with its negation. Unbiased for every reported
        # statistic; cuts the Monte Carlo error of means/percentiles at the
        # same path count (measured reduction documented in docs/CONFIG.md).
        # Off by default so default results match the reference's iid
        # sampling model exactly.
        "antithetic": Field(bool, False),
        # Dynamic spending rule (extension): None keeps the reference's fixed
        # real spending bit for bit; see SpendingGuardrailsConfig.
        "spending_guardrails": Field(
            SpendingGuardrailsConfig, None, optional=True
        ),
        # Jump-diffusion crash risk (extension): None keeps the reference's
        # pure-lognormal returns bit for bit; see MarketCrashConfig.
        "market_crashes": Field(MarketCrashConfig, None, optional=True),
        # Stochastic lifespan (extension): None keeps the reference's fixed
        # retirement horizon bit for bit; see LongevityConfig.
        "longevity": Field(LongevityConfig, None, optional=True),
        # Retained for config-file compatibility; the engine parallelises
        # over devices instead of processes (reference used a
        # multiprocessing.Pool).
        "num_processes": Field(int, 1, ge=1, optional=True),
        "other_income_streams": Field(
            OtherIncomeStreamConfig, default_factory=list, list_of=True
        ),
    }

    def _warn(self, values: Dict[str, Any]) -> None:
        if values["inflation_rate_volatility"] > 0.05:
            log.warning(
                "Scenario '%s' sets inflation volatility to %.1f%% — above the "
                "5%% sanity threshold; double-check the input is a fraction, "
                "not a percent.",
                values["Nickname"],
                values["inflation_rate_volatility"] * 100,
            )
        if values["inv1_returns_volatility"] < 0.05:
            log.warning(
                "Scenario '%s' sets inv1 (equity) volatility to %.1f%% — below "
                "the 5%% sanity threshold (broad equity indices run near 15%%); "
                "ruin-risk estimates may look rosier than reality.",
                values["Nickname"],
                values["inv1_returns_volatility"] * 100,
            )

    @property
    def allocation_inv2_pct(self) -> float:
        return 1.0 - self.allocation_inv1_pct


def load_config_from_json(file_path: str) -> Dict[str, Any]:
    """Read a scenario JSON file into a plain dict (validate via ``Config``)."""
    if not os.path.exists(file_path):
        raise ConfigurationError(f"Configuration file not found at: {file_path}")
    try:
        with open(file_path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except json.JSONDecodeError as exc:
        raise ConfigurationError(f"Error parsing JSON file '{file_path}': {exc}") from exc
    except OSError as exc:  # pragma: no cover - unexpected IO failures
        raise ConfigurationError(
            f"Unexpected error reading config file '{file_path}': {exc}"
        ) from exc
