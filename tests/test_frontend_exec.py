"""EXECUTABLE frontend verification.

No browser or JS engine exists in this image, so these tests run the
shipped dashboard sources under tools/jsmini — a vendored interpreter for
the ES subset the frontend uses, plus a DOM stub. Every card builder
executes against payloads produced by the REAL engine (the same
build_result output the server serializes), and the SSE client parses real
frame bytes through a stubbed fetch; assertions are on the DOM the code
actually builds.
"""

import math

import pytest

from conftest import base_config_dict, make_config
from monte_carlo_retirement_tpu.engine.simulator import (
    RetirementMonteCarloSimulator,
)
from monte_carlo_retirement_tpu.hosts.grid import GridRequest, run_grid_request
from monte_carlo_retirement_tpu.hosts.payload import build_result

from tools.jsmini import UNDEFINED, load_frontend
from tools.jsmini.interp import js_str


def _floatify(value):
    """JS numbers are doubles: convert the payload's ints so strict
    equality inside the scripts behaves as it would on JSON.parse output."""
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return float(value)
    if isinstance(value, list):
        return [_floatify(v) for v in value]
    if isinstance(value, dict):
        return {k: _floatify(v) for k, v in value.items()}
    return value


@pytest.fixture(scope="module")
def result_payload():
    config = make_config(
        num_simulations_main=64, retirement_years=6, seed=21,
        monthly_expenses=2_800.0,
    )
    sim = RetirementMonteCarloSimulator(config)
    sim.use_final_seeds()
    payload = build_result(
        config, sim, required_w_months=18,
        search_curve=[
            {"working_months": 0, "working_years": 0.0, "probability": 40.0},
            {"working_months": 18, "working_years": 1.5, "probability": 85.0},
        ],
        include_raw=True,
    )
    return _floatify(payload)


@pytest.fixture(scope="module")
def binned_payload():
    config = make_config(
        num_simulations_main=64, retirement_years=6, seed=21,
        monthly_expenses=2_800.0,
    )
    sim = RetirementMonteCarloSimulator(config)
    sim.use_final_seeds()
    return _floatify(
        build_result(config, sim, required_w_months=18, include_raw=False)
    )


@pytest.fixture()
def fe():
    return load_frontend(["charts.js", "views.js", "api.js"])


def _texts(el, tag):
    return [t.textContent for t in el.getElementsByTagName(tag)]


def test_summary_card_renders_metrics(fe, result_payload):
    card = fe.call("views.js", "summaryCard", result_payload)
    assert card.className == "card"
    text = card.textContent
    s = result_payload["summary"]
    assert f"{s['success_probability']:.2f}%" in text
    # The ± one-sigma Monte Carlo error renders when it is meaningful. This
    # fixture succeeds on every path, so sigma is 0.0 and the suffix hides;
    # a nonzero sigma renders, and a payload without the field at all
    # (reference-server shape) also drops the suffix.
    import copy as _copy

    assert s["success_probability_sigma"] == 0.0 and "±" not in text
    noisy = _copy.deepcopy(result_payload)
    noisy["summary"]["success_probability"] = 93.75
    noisy["summary"]["success_probability_sigma"] = 3.03
    assert "± 3.03" in fe.call("views.js", "summaryCard", noisy).textContent
    bare = _copy.deepcopy(result_payload)
    del bare["summary"]["success_probability_sigma"]
    assert "±" not in fe.call("views.js", "summaryCard", bare).textContent
    assert "Estimated working period" in text
    assert f"{int(s['required_working_months'])} mo" in text
    # percentile table renders all nine columns
    pct_table = card.querySelector("table.pct-table")
    assert pct_table is not None
    header = pct_table.getElementsByTagName("th")
    assert [h.textContent for h in header][:2] == ["P1", "P5"]


def test_trajectory_card_builds_fan_and_markers(fe, result_payload):
    card = fe.call("views.js", "trajectoryCard", result_payload)
    svg = card.querySelector("svg")
    assert svg is not None
    paths = svg.getElementsByTagName("path")
    # two bands + five sample paths + median
    assert len(paths) >= 8
    # band paths close their polygon
    assert any(p.getAttribute("d").endswith("Z") for p in paths)
    # reference marker: numbered badge for "Retirement Starts"
    texts = _texts(svg, "text")
    assert "1" in texts
    legend_text = card.textContent
    assert "Retirement Starts" in legend_text and "P25–P75" in legend_text
    # nominal/real toggle exists and re-renders on click
    buttons = card.getElementsByTagName("button")
    assert [b.textContent for b in buttons] == ["Nominal $", "Real (today's $)"]
    buttons[1].dispatch(fe.interp, "click")
    assert buttons[1].className == "active"


def test_trajectory_hover_tooltip(fe, result_payload):
    card = fe.call("views.js", "trajectoryCard", result_payload)
    svg = card.querySelector("svg")
    rects = svg.getElementsByTagName("rect")
    overlay = [r for r in rects if r.getAttribute("fill") == "transparent"][-1]
    overlay.dispatch(fe.interp, "mousemove",
                     {"clientX": 300.0, "clientY": 60.0})
    tooltip = card.querySelector(".chart-tooltip")
    assert "year " in tooltip.innerHTML and "P50" in tooltip.innerHTML
    overlay.dispatch(fe.interp, "mouseleave")
    assert tooltip.style.__js_get__("opacity") == "0"


def test_withdrawal_rate_card(fe, result_payload):
    card = fe.call("views.js", "withdrawalRateCard",
                   result_payload["withdrawal_rate"])
    assert "64 paths" in card.textContent
    svg = card.querySelector("svg")
    assert svg is not None
    assert any("4% rule" == t for t in _texts(svg, "text"))


def test_ruin_and_histogram_cards_raw(fe, result_payload):
    ruin = fe.call("views.js", "ruinCard", result_payload["ruin_histogram"])
    assert "failed" in ruin.textContent
    hist = fe.call("views.js", "histogramCard", result_payload["histogram"])
    svg = hist.querySelector("svg")
    bars = [r for r in svg.getElementsByTagName("rect")
            if r.getAttribute("opacity") == "0.8"]
    flags = result_payload["histogram"]["success_flags"]
    finals = [v for v, ok in zip(result_payload["histogram"]["final_balances"],
                                 flags) if ok]
    assert sum(1 for _ in bars) >= 1
    assert f"({100 * len(finals) / len(flags):.1f}%)" in hist.textContent


def test_histogram_card_binned_equals_client_binning(fe, result_payload,
                                                     binned_payload):
    """The pre-binned server form and client-side binning of the raw form
    must draw the same bars — executed, not inferred."""
    raw_card = fe.call("views.js", "histogramCard", result_payload["histogram"])
    binned_card = fe.call("views.js", "histogramCard",
                          binned_payload["histogram"])

    def bars(card):
        svg = card.querySelector("svg")
        return [
            (float(r.getAttribute("x")), float(r.getAttribute("height")))
            for r in svg.getElementsByTagName("rect")
            if r.getAttribute("opacity") == "0.8"
        ]

    raw_bars, binned_bars = bars(raw_card), bars(binned_card)
    assert len(raw_bars) == len(binned_bars)
    for (rx, rh), (bx, bh) in zip(raw_bars, binned_bars):
        # identical counts -> identical heights; x positions may differ by
        # the wire format's cent-rounding of bin edges
        assert rh == bh
        assert abs(rx - bx) < 0.01
    # median annotation matches between forms
    def median_label(card):
        svg = card.querySelector("svg")
        return [t for t in _texts(svg, "text") if t.startswith("median ")]

    assert median_label(raw_card) == median_label(binned_card)


def test_search_curve_card(fe, result_payload):
    card = fe.call("views.js", "searchCurveCard", result_payload["search_curve"])
    assert "search probes: 2" in card.textContent
    svg = card.querySelector("svg")
    assert any(t.startswith("target ") for t in _texts(svg, "text"))


def test_grid_card_rows_and_bars(fe):
    req = GridRequest(
        config=base_config_dict(num_simulations_main=48, retirement_years=3),
        variants=[
            {"name": "base", "overrides": {}},
            {"name": "frugal", "overrides": {"monthly_expenses": 1_200.0}},
        ],
        working_months=6,
    )
    grid = _floatify(run_grid_request(req))
    card = fe.call("views.js", "gridCard", grid)
    assert "2 variants" in card.textContent
    table = card.querySelector("table.grid-table")
    body_rows = table.getElementsByTagName("tr")[1:]
    assert len(body_rows) == 2
    assert body_rows[0].textContent.split()[0] == "base"
    # success bar widths encode the probabilities
    bar = body_rows[1].querySelector(".grid-bar")
    assert bar is not None and bar.style.__js_get__("width").endswith("%")
    for key in ("p5", "p25", "p50", "p75", "p95"):
        assert grid["rows"][0]["final_balance_percentiles"][key] >= 0.0


def test_sensitivity_card_tornado(fe):
    """sensitivityCard on a REAL engine payload: tornado ordering, bars on
    the signed side, AD column present when requested."""
    from monte_carlo_retirement_tpu.hosts.sensitivity import (
        SensitivityRequest, run_sensitivity_request,
    )

    req = SensitivityRequest(
        config=base_config_dict(num_simulations_main=64, retirement_years=3,
                                seed=4, monthly_expenses=2_500.0),
        working_months=12,
        params=["monthly_expenses", "inv1_returns_mean"],
        num_paths=256,
        include_ad=True,
        ad_num_paths=256,
    )
    sens = _floatify(run_sensitivity_request(req))
    card = fe.call("views.js", "sensitivityCard", sens)
    assert "2 parameters" in card.textContent
    assert "256 paths" in card.textContent
    table = card.querySelector("table.tornado-table")
    body_rows = table.getElementsByTagName("tr")[1:]
    assert len(body_rows) == 2
    # AD cross-check column rendered
    headers = [h.textContent for h in table.getElementsByTagName("th")]
    assert any("AD" in h for h in headers)
    # bars land on the signed side and widths encode |Δ/step|
    for row, payload_row in zip(body_rows, sens["rows"]):
        v = payload_row["success_per_step"]
        side = "tornado-left" if v < 0 else "tornado-right"
        half = row.querySelector(f".{side}")
        bar = half.querySelector(".grid-bar")
        if v != 0:
            assert bar is not None
            assert bar.style.__js_get__("width").endswith("%")
    # rows arrive tornado-ordered from the server; the card preserves it
    mags = [abs(r["success_per_step"]) for r in sens["rows"]]
    assert mags == sorted(mags, reverse=True)


def test_optimize_card_metrics_and_curve(fe):
    """optimizeCard on a REAL engine payload: metric tiles, the round-1
    curve chart with the best-value marker, hover tooltip."""
    from monte_carlo_retirement_tpu.hosts.optimize import (
        OptimizeRequest, run_optimize_request,
    )

    req = OptimizeRequest(
        config=base_config_dict(num_simulations_main=64, retirement_years=3,
                                seed=4),
        working_months=12,
        param="allocation_inv1_pct",
        points=5,
        rounds=2,
        num_paths=128,
    )
    opt = _floatify(run_optimize_request(req))
    card = fe.call("views.js", "optimizeCard", opt)
    text = card.textContent
    assert "Optimize: allocation_inv1_pct" in text
    assert "10 evaluations" in text
    assert "Best value" in text and "Refined bracket" in text
    svg = card.querySelector("svg")
    assert svg is not None
    labels = _texts(svg, "text")
    assert any(lbl.startswith("best ") for lbl in labels)


def test_optimize_joint_card_heatmap(fe):
    """optimizeJointCard on a REAL joint engine payload: per-field metric
    tiles and the round-1 K x K surface as a single-hue heatmap with one
    cell per grid row, per-cell tooltips and the optimum ring."""
    from monte_carlo_retirement_tpu.hosts.optimize import (
        OptimizeRequest, run_optimize_request,
    )

    req = OptimizeRequest(
        config=base_config_dict(num_simulations_main=64, retirement_years=3,
                                seed=4),
        working_months=12,
        params=[
            {"name": "allocation_inv1_pct"},
            {"name": "equity_inflation_correlation", "lo": -0.5, "hi": 0.5},
        ],
        points=3,
        rounds=2,
        num_paths=128,
    )
    opt = _floatify(run_optimize_request(req))
    card = fe.call("views.js", "optimizeJointCard", opt)
    text = card.textContent
    assert ("Optimize: allocation_inv1_pct × equity_inflation_correlation"
            in text)
    assert "18 evaluations" in text
    assert "Best allocation_inv1_pct" in text
    assert "equity_inflation_correlation bracket" in text
    svg = card.querySelector("svg")
    assert svg is not None
    rects = svg.getElementsByTagName("rect")
    assert len(rects) == 9  # one cell per round-1 grid row
    # every cell carries a hover tooltip naming both field values
    tips = [t.textContent for t in svg.getElementsByTagName("title")]
    assert len(tips) == 9
    assert all("allocation_inv1_pct" in t and "→" in t for t in tips)
    # the refined optimum is ringed
    assert len(svg.getElementsByTagName("circle")) == 1
    assert "darker = higher success_probability" in text


class _Reader:
    def __init__(self, chunks):
        self._chunks = list(chunks)
        self.cancelled = False

    def read(self):
        if self._chunks:
            return {"value": self._chunks.pop(0), "done": False}
        return {"value": UNDEFINED, "done": True}

    def cancel(self):
        self.cancelled = True


class _Body:
    def __init__(self, chunks):
        self.reader = _Reader(chunks)

    def getReader(self):
        return self.reader


class _Response:
    def __init__(self, chunks, ok=True, status=200, text=""):
        self.ok = ok
        self.status = float(status)
        self.body = _Body(chunks)
        self._text = text

    def text(self):
        return self._text


def _run_stream(fe, chunks, response=None):
    events = []
    resp = response or _Response(chunks)
    fe.set_global("fetch", lambda url, opts=None: resp)
    fe.interp.call_function(
        fe.get("api.js", "runSimulationStream"),
        [
            {"scenario": "t"},
            UNDEFINED,
            {
                "onProgress": lambda e: events.append(("progress", e)),
                "onResult": lambda d: events.append(("result", d)),
                "onError": lambda m: events.append(("error", m)),
            },
        ],
    )
    return events, resp


def test_sse_client_parses_frames_and_dispatches(fe):
    chunks = [
        'data: {"type": "phase", "phase": "search"}\n\n'
        'data: {"type": "search_iter", "iteration": 1, "working_months": 12,'
        ' "working_years": 1, "probability": 50.5, "target": 80}\n\n',
        # a frame split across network chunks must reassemble
        'data: {"type": "res',
        'ult", "data": {"scenario": "t", "ok": true}}\n\n',
    ]
    events, _ = _run_stream(fe, chunks)
    kinds = [k for k, _ in events]
    assert kinds == ["progress", "progress", "result"]
    assert events[0][1]["type"] == "phase"
    assert events[1][1]["probability"] == 50.5
    assert events[2][1]["scenario"] == "t"


def test_sse_client_error_frame_and_missing_terminal(fe):
    events, _ = _run_stream(
        fe, ['data: {"type": "error", "message": "boom"}\n\n'],
    )
    assert events == [("error", "boom")]

    events, _ = _run_stream(
        fe, ['data: {"type": "phase", "phase": "search"}\n\n'],
    )
    assert events[-1][0] == "error"
    assert "without a result" in events[-1][1]


def test_sse_client_http_error_routes_to_onerror(fe):
    events, _ = _run_stream(
        fe, [], response=_Response([], ok=False, status=422,
                                   text="Invalid configuration"),
    )
    assert events == [("error", "Invalid configuration")]


def test_sse_client_rejects_bad_override(fe):
    events = []
    fe.set_global("fetch", lambda url, opts=None: _Response([]))
    fe.interp.call_function(
        fe.get("api.js", "runSimulationStream"),
        [
            {"scenario": "t"},
            -3.0,
            {
                "onProgress": lambda e: events.append(("progress", e)),
                "onResult": lambda d: events.append(("result", d)),
                "onError": lambda m: events.append(("error", m)),
            },
        ],
    )
    assert events and events[0][0] == "error"
    assert "nonnegative integer" in events[0][1]


def test_grid_stream_client(fe):
    events = []
    chunks = [
        'data: {"type": "grid_chunk", "done": 1, "total": 2}\n\n',
        'data: {"type": "result", "data": {"total_scenarios": 2, "rows": []'
        ', "scenario": "t", "num_paths": 8}}\n\n',
    ]
    fe.set_global("fetch", lambda url, opts=None: _Response(chunks))
    fe.interp.call_function(
        fe.get("api.js", "runGridStream"),
        [
            {"config": {}, "variants": [], "working_months": 0.0},
            {
                "onProgress": lambda e: events.append(("progress", e)),
                "onResult": lambda d: events.append(("result", d)),
                "onError": lambda m: events.append(("error", m)),
            },
        ],
    )
    assert [k for k, _ in events] == ["progress", "result"]
    assert events[1][1]["total_scenarios"] == 2


ALL_MODULES = ["charts.js", "views.js", "api.js", "editor.js", "app.js"]


class _RoutedFetch:
    """URL-routing fetch stub: default config, validate, SSE simulate."""

    def __init__(self, default_config, sse_frames, validate_ok=True):
        self.default_config = default_config
        self.sse_frames = sse_frames
        self.validate_ok = validate_ok
        self.calls = []
        self.bodies = []  # raw POST bodies (JSON strings), call-aligned

    def __call__(self, url, opts=None):
        self.calls.append(str(url))
        self.bodies.append(
            opts.get("body") if isinstance(opts, dict) else None
        )
        if url.endswith("/api/config/default"):
            return _JsonResponse(self.default_config)
        if url.endswith("/api/analysis/meta"):
            return _JsonResponse(_floatify({
                "parameters": [
                    {"name": "allocation_inv1_pct", "lo": 0.0, "hi": 1.0,
                     "kind": "rate"},
                    {"name": "monthly_expenses", "lo": 0.0, "hi": None,
                     "kind": "dollar"},
                ],
                "objectives": ["success_probability"],
                "default_sensitivity_params": ["monthly_expenses"],
                "max_joint_rows": 257,
            }))
        if url.endswith("/api/validate"):
            if self.validate_ok:
                return _JsonResponse({"valid": True, "scenario": "t"})
            return _Response([], ok=False, status=422, text="bad config")
        if url.endswith("/stream"):
            return _Response(list(self.sse_frames))
        return _Response([], ok=False, status=404, text="not found")


class _JsonResponse:
    def __init__(self, data):
        self.ok = True
        self.status = 200.0
        self._d = data

    def json(self):
        return self._d

    def text(self):
        import json as _j

        return _j.dumps(self._d)


def test_full_app_boot_and_simulation_flow(result_payload):
    """The COMPLETE user flow, executed: index.html + all five modules
    boot, the editor renders the fetched default config, the user sets an
    override and clicks Run, SSE progress streams in, and every result
    card lands in the DOM."""
    import json as _j

    default_cfg = base_config_dict(num_simulations_main=64,
                                   retirement_years=6)
    frames = [
        'data: {"type": "phase", "phase": "final_sim", "message": "go"}\n\n',
        "data: " + _j.dumps({"type": "result", "data": result_payload})
        + "\n\n",
    ]
    fetch = _RoutedFetch(_floatify(default_cfg), frames)
    fe = load_frontend(ALL_MODULES, fetch=fetch, load_page=True)
    doc = fe.document

    # Boot: editor form rendered from the fetched default scenario.
    editor_el = doc.getElementById("config-editor")
    assert "Initial balance" in editor_el.textContent
    assert any(u.endswith("/api/config/default") for u in fetch.calls)

    # Discovery: the analysis panels got parameter-name completion.
    assert any(u.endswith("/api/analysis/meta") for u in fetch.calls)
    dl = doc.getElementById("param-names")
    assert dl is not None
    opts = [o.value for o in dl.getElementsByTagName("option")]
    assert "allocation_inv1_pct" in opts and "monthly_expenses" in opts
    assert doc.getElementById("opt-param").attributes.get("list") \
        == "param-names"

    # The user overrides the working months and runs.
    override = doc.getElementById("override-input")
    assert override is not None
    override.value = "18"
    run_btn = doc.getElementById("run-btn")
    run_btn.dispatch(fe.interp, "click")

    # Validate + stream both happened.
    assert any(u.endswith("/api/validate") for u in fetch.calls)
    assert any(u.endswith("/api/simulate/stream") for u in fetch.calls)

    results = doc.getElementById("results")
    titles = [h.textContent for h in results.getElementsByTagName("h3")]
    assert "Summary" in titles
    assert "Portfolio trajectory" in titles
    assert "Final balance distribution" in titles
    assert doc.getElementById("empty-state").className == "hidden"
    # run finished: progress panel hidden again, button re-enabled
    assert doc.getElementById("progress-panel").className.endswith("hidden")
    assert run_btn.disabled is False


def _dom_contract_state(doc, payload):
    """Mirror scripts/browser_verify._EXTRACT_JS over the jsmini DOM stub,
    so the browser handoff's contract checks run against the DOM the real
    frontend code builds in CI (the browser run then only re-verifies the
    environment, not the logic)."""

    def attr(el, name):
        v = el.getAttribute(name)
        return None if v in (None, UNDEFINED) else js_str(v)

    cards = []
    results = doc.getElementById("results")
    for c in results.children:
        if "card" not in (c.className or "").split():
            continue
        h3 = c.querySelector("h3")
        svg = c.querySelector("svg")
        paths = svg.getElementsByTagName("path") if svg else []
        bands, lines = [], 0
        for p in paths:
            if attr(p, "stroke") == "none" and attr(p, "fill") != "none":
                d = attr(p, "d") or ""
                bands.append(d.count("M") + d.count("L"))
            elif attr(p, "fill") == "none":
                lines += 1
        cards.append({
            "title": h3.textContent if h3 is not None else "",
            "bands": bands,
            "lines": lines,
            "bars": sum(
                1 for r in (svg.getElementsByTagName("rect") if svg else [])
                if attr(r, "opacity") is not None
            ),
            "markers": len(svg.getElementsByTagName("circle")) if svg else 0,
            "svgText": "|".join(
                t.textContent
                for t in (svg.getElementsByTagName("text") if svg else [])
            ),
        })
    metrics = {
        m.querySelector(".k").textContent.strip():
            m.querySelector(".v").textContent.strip()
        for m in results.querySelectorAll(".metric")
    }
    banner = doc.getElementById("error-banner")
    return {
        "cards": cards,
        "metrics": metrics,
        "pctHeaders": [
            th.textContent.strip()
            for th in results.querySelectorAll(".pct-table th")
        ],
        "errorBanner": banner.textContent if banner is not None else None,
        "payload": payload,
    }


def test_browser_contract_holds_on_jsmini_dom(result_payload):
    """scripts/browser_verify.py's payload-vs-DOM contract, executed in CI:
    the same checks the playwright pass runs (card set == payload fields,
    summary numbers, stacked-band polygon geometry, 4%-rule line, histogram
    bar counts) must hold on the DOM the shipped frontend builds."""
    import importlib.util
    import json as _j
    import os as _os

    spec = importlib.util.spec_from_file_location(
        "browser_verify",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), "scripts", "browser_verify.py"),
    )
    bv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bv)

    default_cfg = base_config_dict(num_simulations_main=64,
                                   retirement_years=6)
    frames = [
        "data: " + _j.dumps({"type": "result", "data": result_payload})
        + "\n\n",
    ]
    fetch = _RoutedFetch(_floatify(default_cfg), frames)
    fe = load_frontend(ALL_MODULES, fetch=fetch, load_page=True)
    doc = fe.document
    doc.getElementById("override-input").value = "18"
    doc.getElementById("run-btn").dispatch(fe.interp, "click")

    # The verification hook the playwright pass reads must be published.
    assert getattr(fe.window, "__mcrtLastResult", None) is not None

    state = _dom_contract_state(doc, result_payload)
    assert bv.contract_failures(state, override=18) == []

    # And the contract must actually bite: corrupt one rendered number and
    # one band polygon — both checks must fail.
    sp = [
        m for m in doc.getElementById("results").querySelectorAll(".metric")
        if m.querySelector(".k").textContent == "Success probability"
    ][0]
    sp.querySelector(".v").textContent = "12.34%"
    traj_card = [
        c for c in doc.getElementById("results").children
        if "Portfolio trajectory" in c.textContent
    ][0]
    band = [
        p for p in traj_card.getElementsByTagName("path")
        if js_str(p.getAttribute("stroke") or "") == "none"
    ][0]
    band.setAttribute("d", "M0,0L1,1Z")
    broken = bv.contract_failures(
        _dom_contract_state(doc, result_payload), override=18
    )
    assert any("success probability" in f for f in broken)
    assert any("trajectory bands" in f for f in broken)


def test_app_surfaces_validation_error(result_payload):
    default_cfg = base_config_dict()
    fetch = _RoutedFetch(_floatify(default_cfg), [], validate_ok=False)
    fe = load_frontend(ALL_MODULES, fetch=fetch, load_page=True)
    doc = fe.document
    doc.getElementById("run-btn").dispatch(fe.interp, "click")
    err = doc.getElementById("config-editor").querySelector(".error-box")
    assert err is not None and "bad config" in err.textContent
    # no stream attempted, no results rendered
    assert not any(u.endswith("/stream") for u in fetch.calls)
    assert doc.getElementById("results").children == []


def test_app_grid_panel_flow():
    import json as _j

    grid_result = {
        "scenario": "t", "num_paths": 48.0, "total_scenarios": 2.0,
        "rows": [
            {"name": "base", "working_months": 6.0,
             "success_probability": 97.5, "success_sigma": 0.2,
             "median_final_balance": 1e6, "mean_final_balance": 1.1e6,
             "final_balance_percentiles": {
                 "p5": 1e5, "p25": 5e5, "p50": 1e6, "p75": 2e6, "p95": 4e6,
             }},
            {"name": "frugal", "working_months": 6.0,
             "success_probability": 99.9, "success_sigma": 0.05,
             "median_final_balance": 2e6, "mean_final_balance": 2.1e6,
             "final_balance_percentiles": {
                 "p5": 5e5, "p25": 1e6, "p50": 2e6, "p75": 3e6, "p95": 5e6,
             }},
        ],
    }
    frames = [
        'data: {"type": "grid_chunk", "done": 1, "total": 2}\n\n',
        'data: {"type": "grid_chunk", "done": 2, "total": 2}\n\n',
        "data: " + _j.dumps({"type": "result", "data": grid_result}) + "\n\n",
    ]
    fetch = _RoutedFetch(_floatify(base_config_dict()), frames)
    fe = load_frontend(ALL_MODULES, fetch=fetch, load_page=True)
    doc = fe.document
    doc.getElementById("grid-run").dispatch(fe.interp, "click")
    assert any(u.endswith("/api/grid/stream") for u in fetch.calls)
    results = doc.getElementById("results")
    assert "Scenario grid" in results.textContent
    table = results.querySelector("table.grid-table")
    assert len(table.getElementsByTagName("tr")) == 3  # header + 2 rows
    assert "99.90%" in table.textContent


def test_app_optimize_panel_flow():
    import json as _j

    opt_result = {
        "scenario": "t", "working_months": 240.0, "num_paths": 64.0,
        "param": "allocation_inv1_pct", "objective": "success_probability",
        "base_value": 0.6, "rounds": 2.0, "evaluations": 10.0,
        "success_sigma": 0.4,
        "best": {"value": 0.75, "success_probability": 97.5,
                 "median_final_balance": 1.2e6, "mean_final_balance": 1.4e6},
        "interval": [0.5, 1.0],
        "curve": [
            {"value": v, "success_probability": 80.0 + 10 * v,
             "median_final_balance": 1e6, "mean_final_balance": 1.1e6}
            for v in (0.0, 0.25, 0.5, 0.75, 1.0)
        ],
    }
    frames = [
        'data: {"type": "phase", "phase": "optimize", "message": "go"}\n\n',
        'data: {"type": "optimize_round", "round": 1, "rounds": 2,'
        ' "best_value": 0.75, "best_objective": 97.5,'
        ' "interval": [0.0, 1.0]}\n\n',
        "data: " + _j.dumps({"type": "result", "data": _floatify(opt_result)})
        + "\n\n",
    ]
    fetch = _RoutedFetch(_floatify(base_config_dict()), frames)
    fe = load_frontend(ALL_MODULES, fetch=fetch, load_page=True)
    doc = fe.document
    doc.getElementById("opt-lo").value = "0.2"
    doc.getElementById("opt-run").dispatch(fe.interp, "click")
    assert any(u.endswith("/api/optimize/stream") for u in fetch.calls)
    results = doc.getElementById("results")
    assert "Optimize: allocation_inv1_pct" in results.textContent
    assert "Best value" in results.textContent
    assert results.querySelector("svg") is not None
    assert doc.getElementById("opt-run").disabled is False
    assert doc.getElementById("progress-panel").className.endswith("hidden")


def test_app_optimize_panel_joint_flow():
    """Filling the second parameter switches the panel to the joint form:
    the request body carries `params`, joint optimize_round events drive
    the progress line, and the heatmap card renders."""
    import json as _j

    K = 3
    vals0 = [0.0, 0.5, 1.0]
    vals1 = [-0.5, 0.0, 0.5]
    surface = [
        {"values": [v0, v1],
         "success_probability": 80.0 + 10.0 * v0 - 5.0 * abs(v1),
         "median_final_balance": 1e6, "mean_final_balance": 1.1e6}
        for v0 in vals0 for v1 in vals1
    ]
    opt_result = {
        "scenario": "t", "working_months": 240.0, "num_paths": 64.0,
        "params": ["allocation_inv1_pct", "equity_inflation_correlation"],
        "objective": "success_probability",
        "base_values": [0.6, 0.0], "rounds": 2.0, "evaluations": 18.0,
        "points_per_axis": float(K), "success_sigma": 0.4,
        "best": {"values": [1.0, 0.0], "success_probability": 90.0,
                 "median_final_balance": 1.2e6, "mean_final_balance": 1.4e6},
        "intervals": [[0.5, 1.0], [-0.25, 0.25]],
        "surface": surface,
    }
    frames = [
        'data: {"type": "phase", "phase": "optimize", "message": "go"}\n\n',
        'data: {"type": "optimize_round", "round": 1, "rounds": 2,'
        ' "best_values": [1.0, 0.0], "best_objective": 90.0,'
        ' "intervals": [[0.0, 1.0], [-0.5, 0.5]]}\n\n',
        "data: " + _j.dumps({"type": "result", "data": _floatify(opt_result)})
        + "\n\n",
    ]
    fetch = _RoutedFetch(_floatify(base_config_dict()), frames)
    fe = load_frontend(ALL_MODULES, fetch=fetch, load_page=True)
    doc = fe.document
    doc.getElementById("opt-param2").value = "equity_inflation_correlation"
    doc.getElementById("opt-lo2").value = "-0.5"
    doc.getElementById("opt-hi2").value = "0.5"
    doc.getElementById("opt-run").dispatch(fe.interp, "click")
    assert any(u.endswith("/api/optimize/stream") for u in fetch.calls)
    sent = _j.loads(fetch.bodies[-1])
    assert [p["name"] for p in sent["params"]] == [
        "allocation_inv1_pct", "equity_inflation_correlation",
    ]
    assert sent["params"][1] == {
        "name": "equity_inflation_correlation", "lo": -0.5, "hi": 0.5,
    }
    assert "param" not in sent
    # the objective select's DOM default flows through
    assert sent["objective"] == "success_probability"
    results = doc.getElementById("results")
    text = results.textContent
    assert ("Optimize: allocation_inv1_pct × equity_inflation_correlation"
            in text)
    assert "Best allocation_inv1_pct" in text
    svg = results.querySelector("svg")
    assert svg is not None
    assert len(svg.getElementsByTagName("rect")) == 9
    assert doc.getElementById("opt-run").disabled is False


def test_app_optimize_panel_downside_objective():
    """Choosing a percentile objective in the select posts it, and the
    result card plots objective_value on a money axis."""
    import json as _j

    opt_result = {
        "scenario": "t", "working_months": 240.0, "num_paths": 64.0,
        "param": "allocation_inv1_pct", "objective": "p5_final_balance",
        "base_value": 0.6, "rounds": 1.0, "evaluations": 5.0,
        "success_sigma": 0.4,
        "best": {"value": 0.5, "success_probability": 97.5,
                 "median_final_balance": 1.2e6, "mean_final_balance": 1.4e6,
                 "objective_value": 4.2e5},
        "interval": [0.25, 0.75],
        "curve": [
            {"value": v, "success_probability": 90.0,
             "median_final_balance": 1e6, "mean_final_balance": 1.1e6,
             "objective_value": 4e5 - abs(v - 0.5) * 1e5}
            for v in (0.0, 0.25, 0.5, 0.75, 1.0)
        ],
    }
    frames = [
        'data: {"type": "phase", "phase": "optimize", "message": "go"}\n\n',
        "data: " + _j.dumps({"type": "result", "data": _floatify(opt_result)})
        + "\n\n",
    ]
    fetch = _RoutedFetch(_floatify(base_config_dict()), frames)
    fe = load_frontend(ALL_MODULES, fetch=fetch, load_page=True)
    doc = fe.document
    doc.getElementById("opt-objective").value = "p5_final_balance"
    doc.getElementById("opt-points").value = "5"
    doc.getElementById("opt-rounds").value = "1"
    doc.getElementById("opt-run").dispatch(fe.interp, "click")
    sent = _j.loads(fetch.bodies[-1])
    assert sent["objective"] == "p5_final_balance"
    assert sent["points"] == 5 and sent["rounds"] == 1
    results = doc.getElementById("results")
    assert "maximize p5_final_balance" in results.textContent
    svg = results.querySelector("svg")
    # money-formatted y axis (objective is a balance, not a percent)
    labels = _texts(svg, "text")
    assert any("$" in lbl or "k" in lbl or "M" in lbl for lbl in labels)


def test_dom_select_value_semantics():
    """The DOM stub's <select> matches real browsers: the `selected`
    option wins, else the FIRST option — even when its value is "" — and
    an option without a value attribute falls back to its text."""
    from tools.jsmini.dom import Document

    doc = Document()
    host = doc.createElement("div")
    host.innerHTML = (
        '<select id="a"><option value="">(none)</option>'
        '<option value="x">X</option></select>'
        '<select id="b"><option value="x">X</option>'
        '<option value="y" selected>Y</option></select>'
        '<select id="c"><option>plain text</option></select>'
    )
    sel_a, sel_b, sel_c = host.getElementsByTagName("select")
    assert sel_a.value == ""  # first option wins despite empty value
    assert sel_b.value == "y"  # selected overrides first
    assert sel_c.value == "plain text"  # text-content fallback


def test_app_optimize_panel_rejects_empty_param():
    fe = _boot()
    doc = fe.document
    doc.getElementById("opt-param").value = "  "
    doc.getElementById("opt-run").dispatch(fe.interp, "click")
    err = doc.getElementById("opt-error")
    assert "Name a config field" in err.textContent


def test_app_sensitivity_panel_flow():
    sens_result = {
        "scenario": "t", "working_months": 240.0, "num_paths": 64.0,
        "rows": [
            {"param": "monthly_expenses", "base_value": 5000.0,
             "step_plus": 100.0, "step_minus": 100.0,
             "success_base": 90.0, "success_plus": 88.0,
             "success_minus": 92.0, "d_success": -0.02,
             "d_median_final": -150.0, "d_mean_final": -180.0,
             "success_per_step": -1.0, "practical_step": 50.0,
             "success_sigma": 0.4},
            {"param": "inv1_returns_mean", "base_value": 0.08,
             "step_plus": 0.005, "step_minus": 0.005,
             "success_base": 90.0, "success_plus": 91.0,
             "success_minus": 89.0, "d_success": 200.0,
             "d_median_final": 2e6, "d_mean_final": 3e6,
             "success_per_step": 1.0, "practical_step": 0.005,
             "success_sigma": 0.4},
        ],
    }

    import json as _j

    # The panel consumes the SSE endpoint: per-dispatch grid_chunk progress
    # (the 1+2K probe rows run as chunked device dispatches) then the result.
    frames = [
        'data: {"type": "phase", "phase": "sensitivity"}\n\n',
        'data: {"type": "grid_chunk", "done": 2, "total": 5}\n\n',
        'data: {"type": "grid_chunk", "done": 5, "total": 5}\n\n',
        "data: " + _j.dumps(
            {"type": "result", "data": _floatify(sens_result)}
        ) + "\n\n",
    ]
    fetch = _RoutedFetch(_floatify(base_config_dict()), frames)
    fe = load_frontend(ALL_MODULES, fetch=fetch, load_page=True)
    doc = fe.document
    doc.getElementById("sens-params").value = " monthly_expenses, inv1_returns_mean "
    doc.getElementById("sens-run").dispatch(fe.interp, "click")
    assert any(u.endswith("/api/sensitivity/stream") for u in fetch.calls)
    results = doc.getElementById("results")
    assert "Sensitivity (tornado)" in results.textContent
    table = results.querySelector("table.tornado-table")
    assert len(table.getElementsByTagName("tr")) == 3  # header + 2 rows
    assert "monthly_expenses" in table.textContent
    # negative row bars left/red, positive right/green
    body_rows = table.getElementsByTagName("tr")[1:]
    assert body_rows[0].querySelector(".tornado-left .grid-bar-bad") is not None
    assert body_rows[1].querySelector(".tornado-right .grid-bar-good") is not None
    assert doc.getElementById("sens-run").disabled is False
    assert doc.getElementById("progress-panel").className.endswith("hidden")


def test_app_sensitivity_panel_surfaces_http_error():
    class _ErrFetch(_RoutedFetch):
        def __call__(self, url, opts=None):
            if str(url).endswith("/api/sensitivity/stream"):
                self.calls.append(str(url))
                return _Response([], ok=False, status=422,
                                 text="Unknown sensitivity parameters")
            return super().__call__(url, opts)

    fe = load_frontend(ALL_MODULES,
                       fetch=_ErrFetch(_floatify(base_config_dict()), []),
                       load_page=True)
    doc = fe.document
    doc.getElementById("sens-run").dispatch(fe.interp, "click")
    err = doc.getElementById("sens-error")
    assert "Unknown sensitivity parameters" in err.textContent
    assert not err.className.endswith("hidden")
    assert doc.getElementById("sens-run").disabled is False


def _boot(fetch=None, default=None):
    fetch = fetch or _RoutedFetch(_floatify(default or base_config_dict()), [])
    return load_frontend(ALL_MODULES, fetch=fetch, load_page=True)


def _find_button(root, text):
    for b in root.getElementsByTagName("button"):
        if b.textContent == text:
            return b
    raise AssertionError(f"no button {text!r}")


def test_editor_json_mode_roundtrip_and_error():
    fe = _boot()
    doc = fe.document
    editor_el = doc.getElementById("config-editor")
    _find_button(editor_el, "JSON").dispatch(fe.interp, "click")
    ta = doc.getElementById("json-editor")
    assert '"initial_balance"' in ta.value

    # Corrupt JSON: switching back to Form must refuse and show the error.
    ta.value = "{broken"
    _find_button(editor_el, "Form").dispatch(fe.interp, "click")
    assert doc.getElementById("json-editor") is not None  # still JSON mode
    err = editor_el.querySelector(".error-box")
    assert "Invalid JSON" in err.textContent

    # Valid edit flows back into the form renderer.
    import json as _j

    cfg = _floatify(base_config_dict(monthly_expenses=3_333.0))
    ta.value = _j.dumps(cfg)
    _find_button(editor_el, "Form").dispatch(fe.interp, "click")
    assert doc.getElementById("json-editor") is None
    assert fe.interp.get_member(
        fe.modules["app.js"].lookup("editor"), "config"
    )["monthly_expenses"] == 3333.0

    # Non-object JSON root is rejected with the dedicated message.
    _find_button(editor_el, "JSON").dispatch(fe.interp, "click")
    doc.getElementById("json-editor").value = "[1, 2]"
    _find_button(editor_el, "Form").dispatch(fe.interp, "click")
    assert "root must be a JSON object" in (
        editor_el.querySelector(".error-box").textContent
    )


def test_editor_percent_and_int_field_semantics():
    fe = _boot()
    doc = fe.document
    editor_el = doc.getElementById("config-editor")
    editor = fe.modules["app.js"].lookup("editor")

    inputs = editor_el.getElementsByTagName("input")
    labels = editor_el.getElementsByTagName("label")
    # Find "Inv1 return mean / yr" percent input: fraction shown as percent.
    def input_for(label_text):
        for lbl in labels:
            if lbl.textContent.startswith(label_text):
                field = lbl.parentNode
                return field.getElementsByTagName("input")[0]
        raise AssertionError(f"no field {label_text!r}")

    # Open the Portfolio section is irrelevant for the stub DOM; the field
    # exists regardless of <details> open state.
    pct = input_for("Inv1 return mean / yr")
    assert pct.value == "8"  # 0.08 displayed as percent
    pct.value = "9.5"
    pct.dispatch(fe.interp, "change")
    assert fe.interp.get_member(editor, "config")["inv1_returns_mean"] == 0.095

    # Int field rounds and rewrites its display.
    years = input_for("Retirement years")
    years.value = "10.7"
    years.dispatch(fe.interp, "change")
    assert years.value == "11"
    assert fe.interp.get_member(editor, "config")["retirement_years"] == 11.0

    # Clearing a required numeric field restores the last valid display.
    exp = input_for("Monthly expenses")
    before = exp.value
    exp.value = ""
    exp.dispatch(fe.interp, "change")
    assert exp.value == before


def test_editor_antithetic_toggle_sets_config_flag():
    """The variance-reduction toggle (Simulation section) writes the boolean
    the engine's Statics read; default unchecked because the fetched default
    config omits the field."""
    fe = _boot()
    doc = fe.document
    editor_el = doc.getElementById("config-editor")
    editor = fe.modules["app.js"].lookup("editor")

    toggle = None
    for lbl in editor_el.getElementsByTagName("label"):
        if "Antithetic sampling" in lbl.textContent:
            toggle = lbl.getElementsByTagName("input")[0]
    assert toggle is not None, "antithetic toggle not rendered"
    assert not toggle.checked
    toggle.checked = True
    toggle.dispatch(fe.interp, "change")
    assert fe.interp.get_member(editor, "config")["antithetic"] is True
    toggle.checked = False
    toggle.dispatch(fe.interp, "change")
    assert fe.interp.get_member(editor, "config")["antithetic"] is False


def test_editor_glide_percent_opt_field_semantics():
    """The glide endpoint is an OPTIONAL percent: blank means null (constant
    allocation), a value edits as percent and stores a fraction."""
    fe = _boot()
    doc = fe.document
    editor_el = doc.getElementById("config-editor")
    editor = fe.modules["app.js"].lookup("editor")

    field_input = None
    for lbl in editor_el.getElementsByTagName("label"):
        if lbl.textContent.startswith("Inv1 allocation at retirement"):
            field_input = lbl.parentNode.getElementsByTagName("input")[0]
    assert field_input is not None, "glide field not rendered"
    assert field_input.value == ""  # default config omits the field
    field_input.value = "30"
    field_input.dispatch(fe.interp, "change")
    assert fe.interp.get_member(editor, "config")[
        "allocation_inv1_final_pct"
    ] == pytest.approx(0.3)
    # Clearing an optional percent commits null, not a refused edit.
    field_input.value = ""
    field_input.dispatch(fe.interp, "change")
    assert fe.interp.get_member(editor, "config")[
        "allocation_inv1_final_pct"
    ] is None


def test_editor_guardrails_section_toggle_and_fields():
    """The Spending rule section: enabling writes the nested defaults the
    engine validates, fields edit the nested object, disabling nulls it."""
    fe = _boot()
    doc = fe.document
    editor = fe.modules["app.js"].lookup("editor")

    def find_toggle():
        for lbl in doc.getElementById("config-editor").getElementsByTagName(
            "label"
        ):
            if "Dynamic spending" in lbl.textContent:
                return lbl.getElementsByTagName("input")[0]
        raise AssertionError("guardrails toggle not rendered")

    toggle = find_toggle()
    assert not toggle.checked
    toggle.checked = True
    toggle.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["spending_guardrails"]["upper_wr_pct"] == 6
    assert cfg["spending_guardrails"]["cap_pct"] == 200

    field = None
    for lbl in doc.getElementById("config-editor").getElementsByTagName(
        "label"
    ):
        if lbl.textContent.startswith("Cut when WR above"):
            field = lbl.parentNode.getElementsByTagName("input")[0]
    assert field is not None, "guardrail fields not rendered when enabled"
    field.value = "5.5"
    field.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["spending_guardrails"]["upper_wr_pct"] == 5.5

    toggle = find_toggle()  # re-rendered after enabling
    toggle.checked = False
    toggle.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["spending_guardrails"] is None


def test_editor_crashes_section_toggle_and_fields():
    """The Market risk section: enabling writes the nested market_crashes
    defaults the engine validates, fields edit the nested object, disabling
    nulls it (the reference's pure-lognormal returns)."""
    fe = _boot()
    doc = fe.document
    editor = fe.modules["app.js"].lookup("editor")

    def find_toggle():
        for lbl in doc.getElementById("config-editor").getElementsByTagName(
            "label"
        ):
            if "Market crashes" in lbl.textContent:
                return lbl.getElementsByTagName("input")[0]
        raise AssertionError("market-crash toggle not rendered")

    toggle = find_toggle()
    assert not toggle.checked
    toggle.checked = True
    toggle.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["market_crashes"]["frequency_per_year"] == 0.25
    assert cfg["market_crashes"]["mean_drop_pct"] == 20

    field = None
    for lbl in doc.getElementById("config-editor").getElementsByTagName(
        "label"
    ):
        if lbl.textContent.startswith("Median drop"):
            field = lbl.parentNode.getElementsByTagName("input")[0]
    assert field is not None, "crash fields not rendered when enabled"
    field.value = "35"
    field.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["market_crashes"]["mean_drop_pct"] == 35

    toggle = find_toggle()  # re-rendered after enabling
    toggle.checked = False
    toggle.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["market_crashes"] is None


def test_editor_longevity_section_toggle_and_fields():
    """The Longevity section: enabling writes the nested longevity defaults
    the engine validates, fields edit the nested object, disabling nulls it
    (the reference's fixed retirement horizon)."""
    fe = _boot()
    doc = fe.document
    editor = fe.modules["app.js"].lookup("editor")

    def find_toggle():
        for lbl in doc.getElementById("config-editor").getElementsByTagName(
            "label"
        ):
            if "Stochastic lifespan" in lbl.textContent:
                return lbl.getElementsByTagName("input")[0]
        raise AssertionError("longevity toggle not rendered")

    toggle = find_toggle()
    assert not toggle.checked
    toggle.checked = True
    toggle.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["longevity"]["mode_age"] == 87
    assert cfg["longevity"]["dispersion_years"] == 10
    assert cfg["longevity"]["max_age"] == 115
    # The defaults round-trip through the engine's pydantic schema.
    from monte_carlo_retirement_tpu.config import Config

    Config(**cfg)

    field = None
    for lbl in doc.getElementById("config-editor").getElementsByTagName(
        "label"
    ):
        if lbl.textContent.startswith("Most likely age"):
            field = lbl.parentNode.getElementsByTagName("input")[0]
    assert field is not None, "longevity fields not rendered when enabled"
    field.value = "90"
    field.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["longevity"]["mode_age"] == 90

    toggle = find_toggle()  # re-rendered after enabling
    toggle.checked = False
    toggle.dispatch(fe.interp, "change")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["longevity"] is None


def test_editor_stream_add_remove_and_reset():
    fe = _boot()
    doc = fe.document
    editor_el = doc.getElementById("config-editor")
    editor = fe.modules["app.js"].lookup("editor")

    _find_button(editor_el, "+ Add income stream").dispatch(fe.interp, "click")
    editor_el = doc.getElementById("config-editor")
    cfg = fe.interp.get_member(editor, "config")
    assert len(cfg["other_income_streams"]) == 1
    assert cfg["other_income_streams"][0]["name"] == "Stream 1"
    assert "Stream 1" in editor_el.textContent

    _find_button(editor_el, "Remove").dispatch(fe.interp, "click")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["other_income_streams"] == []

    # Mutate a field, then Reset restores the fetched default.
    _find_button(doc.getElementById("config-editor"), "+ Add income stream") \
        .dispatch(fe.interp, "click")
    _find_button(doc.getElementById("config-editor"), "Reset") \
        .dispatch(fe.interp, "click")
    cfg = fe.interp.get_member(editor, "config")
    assert cfg["other_income_streams"] == []


def test_jsmini_to_exponential_semantics():
    """The vendored toExponential matches JS: unpadded exponent, omitted
    digits -> fewest that round-trip, non-finite -> Infinity/NaN strings
    (views.js fmtSig calls it on any |v| >= 1e5, including Infinity)."""
    from tools.jsmini.builtins import _to_exponential

    assert _to_exponential(123456.789, 2.0) == "1.23e+5"
    assert _to_exponential(-0.00001234, 3.0) == "-1.234e-5"
    assert _to_exponential(0.1, UNDEFINED) == "1e-1"
    assert _to_exponential(1.5, UNDEFINED) == "1.5e+0"
    assert _to_exponential(float("inf"), 2.0) == "Infinity"
    assert _to_exponential(float("nan"), 2.0) == "NaN"


def test_fmt_money_matches_display_rules(fe):
    fmt = fe.get("charts.js", "fmtMoney")
    call = fe.interp.call_function
    assert call(fmt, [1_234_567.0]) == "$1.23M"
    assert call(fmt, [2_500_000_000.0]) == "$2.50B"
    assert call(fmt, [45_000.0]) == "$45k"
    assert call(fmt, [999.4]) == "$999"
    assert not math.isnan(float(js_str(call(fmt, [0.0])).strip("$") or 0))


# ----------------------------------------------------------------------
# The REFERENCE's own API client, executed against this server's bytes
# ----------------------------------------------------------------------

REFERENCE_FRONTEND_SRC = "/root/reference/frontend/src"


@pytest.fixture(scope="module")
def reference_client_env(tmp_path_factory):
    """Load the reference's UNMODIFIED frontend/src/api.js (read from
    /root/reference at test time — never copied into this repo, same
    policy as the engine head-to-head suite) under jsmini."""
    import os

    if not os.path.exists(os.path.join(REFERENCE_FRONTEND_SRC, "api.js")):
        pytest.skip("reference checkout not present")
    # load_frontend resolves modules under <frontend_dir>/js; point a tmp
    # frontend root's js/ at the reference's src/ via symlink.
    root = tmp_path_factory.mktemp("ref_frontend")
    (root / "js").symlink_to(REFERENCE_FRONTEND_SRC)
    return load_frontend(files=["api.js"], frontend_dir=str(root))


def _capture_stream_and_default():
    """Real bytes from THIS server: the SSE stream for an override run and
    the default-config body."""
    import asyncio
    import json as _json

    from aiohttp.test_utils import TestClient, TestServer

    from monte_carlo_retirement_tpu.hosts.server import create_app

    async def scenario():
        client = TestClient(TestServer(create_app()))
        await client.start_server()
        try:
            cfg = make_config(
                num_simulations_main=32, num_simulations_search=16,
                retirement_years=2, seed=9,
            ).model_dump(by_alias=True)
            resp = await client.post(
                "/api/simulate/stream",
                json={"config": cfg, "working_months_override": 6},
            )
            assert resp.status == 200
            stream_text = await resp.text()

            resp = await client.get("/api/config/default")
            assert resp.status == 200
            default_cfg = await resp.json()

            resp = await client.post(
                "/api/simulate",
                json={"config": {"initial_balance": -1.0}},
            )
            assert resp.status == 422
            error_body = await resp.json()
            return cfg, stream_text, default_cfg, error_body
        finally:
            await client.close()

    return asyncio.run(scenario())


def test_reference_client_consumes_this_server(reference_client_env):
    """Wire-compat proof from the CLIENT side: the reference's own
    `runSimulationStream` / `getDefaultConfig` (reference
    frontend/src/api.js:1-78), executed unmodified, parse this server's
    actual response bytes — stream framing, terminal-event contract, and
    the JSON {"detail"} error shape its error path reads."""
    fe = reference_client_env
    cfg, stream_text, default_cfg, error_body = _capture_stream_and_default()

    # --- SSE stream: feed the exact bytes, split mid-frame to exercise
    # the client's chunk reassembly.
    cut = len(stream_text) // 2
    chunks = [stream_text[:cut], stream_text[cut:]]
    events = []
    resp = _Response(chunks)
    fe.set_global("fetch", lambda url, opts=None: resp)
    fe.interp.call_function(
        fe.get("api.js", "runSimulationStream"),
        [
            _floatify(cfg),
            "6",  # the reference passes the override as the input's string
            {
                "onProgress": lambda e: events.append(("progress", e)),
                "onResult": lambda d: events.append(("result", d)),
                "onError": lambda m: events.append(("error", m)),
            },
        ],
    )
    kinds = [k for k, _ in events]
    assert kinds[-1] == "result" and "error" not in kinds
    result = events[-1][1]
    assert result["summary"]["required_working_months"] == 6.0
    assert result["summary"]["working_period_is_estimate"] is False
    assert result["trajectory"]["years"][0] == 0.0

    # --- default config: the reference boot path.
    class _JsonResponse:
        ok = True

        def __init__(self, payload):
            self._payload = payload

        def json(self):
            return self._payload

    fe.set_global(
        "fetch", lambda url, opts=None: _JsonResponse(_floatify(default_cfg))
    )
    got = fe.interp.call_function(fe.get("api.js", "getDefaultConfig"), [])
    if hasattr(got, "value"):  # async fn -> resolved Thenable
        assert got.error is None, got.error
        got = got.value
    assert got["initial_balance"] == float(default_cfg["initial_balance"])

    # --- error path: the reference reads err.detail from the JSON body.
    from tools.jsmini.interp import Thenable

    class _ErrResponse:
        ok = False

        def json(self):
            # fetch's res.json() is a promise; the reference chains .catch
            return Thenable(_floatify(error_body))

    from tools.jsmini.interp import JSThrow

    fe.set_global("fetch", lambda url, opts=None: _ErrResponse())
    try:
        outcome = fe.interp.call_function(
            fe.get("api.js", "runSimulationStream"),
            [_floatify(cfg), UNDEFINED,
             {"onProgress": lambda e: None, "onResult": lambda d: None,
              "onError": lambda m: None}],
        )
    except JSThrow as exc:
        message = str(exc)
    else:  # a rejected thenable is an equally valid surfacing
        assert getattr(outcome, "error", None) is not None
        message = str(outcome.error)
    # The thrown Error carries the server's JSON detail — the exact field
    # the reference reads (reference api.js:30-31).
    assert "Invalid configuration" in message
