// Config editor: dual form/JSON editing, collapsible sections, typed inputs
// (percent fields edit as % but store fractions), income-stream management,
// load/save/reset, and the run controls.

const FIELDS = {
  scenario: { label: "Scenario name", type: "text", section: "Scenario", wide: true },
  initial_balance: { tip: "Portfolio value today, split across both assets at the target allocation.", label: "Initial balance", type: "money", section: "Finances" },
  monthly_contribution: { tip: "Invested every working month; grows annually by the growth rate.", label: "Monthly contribution", type: "money", section: "Finances" },
  contribution_growth_rate_annual: { tip: "Raise applied to the contribution at the start of each working year.", label: "Contribution growth / yr", type: "percent", section: "Finances" },
  monthly_expenses: { tip: "Retirement spending in today's dollars; indexed to the simulated price level.", label: "Monthly expenses (today's $)", type: "money", section: "Finances" },
  current_age: { tip: "Age at T=0; retirement age = current age + working months / 12.", label: "Current age", type: "number", section: "Finances" },
  retirement_years: { tip: "Length of the decumulation phase. Success requires funding every month of it.", label: "Retirement years", type: "int", section: "Finances" },
  allocation_inv1_pct: { tip: "Target weight of asset 1; monthly tax-aware rebalancing restores it.", label: "Allocation to Inv1", type: "percent", section: "Portfolio & taxes" },
  allocation_inv1_final_pct: { tip: "Glide path: the Inv1 target moves linearly from the allocation above to this value at retirement, then holds. Blank = constant allocation.", label: "Inv1 allocation at retirement (glide)", type: "percent-opt", section: "Portfolio & taxes" },
  inv1_returns_mean: { tip: "Arithmetic annual mean; converted to lognormal so E[gross] = 1 + mean.", label: "Inv1 return mean / yr", type: "percent", section: "Portfolio & taxes" },
  inv1_returns_volatility: { tip: "Annual volatility of asset 1 (typical equity ~15%).", label: "Inv1 volatility / yr", type: "percent", section: "Portfolio & taxes" },
  inv1_use_realized_gains_tax_system: { tip: "On: tax on sales (realized gains). Off: annual mark-to-market tax.", label: "Inv1 realized-gains tax", type: "toggle", section: "Portfolio & taxes" },
  inv1_realized_gains_tax_rate: { tip: "Tax on realized gains when selling asset 1.", label: "Inv1 realized tax rate", type: "percent", section: "Portfolio & taxes" },
  inv1_expense_ratio_annual: { tip: "Annual fund fee deducted inside the returns (the realized mean becomes (1+mean)(1-fee)-1). 0 = the reference's fee-free model.", label: "Inv1 expense ratio / yr", type: "percent", section: "Portfolio & taxes" },
  inv1_annual_tax_on_gains_rate: { tip: "Annual tax on positive market P&L (when not using realized taxation).", label: "Inv1 annual gains tax", type: "percent", section: "Portfolio & taxes" },
  inv2_premium_over_inflation_mean: { tip: "Asset 2 compounds inflation times this premium.", label: "Inv2 premium mean / yr", type: "percent", section: "Portfolio & taxes" },
  inv2_premium_over_inflation_volatility: { tip: "Volatility of the premium component.", label: "Inv2 premium volatility", type: "percent", section: "Portfolio & taxes" },
  inv2_expense_ratio_annual: { tip: "Annual fund fee on investment 2, deducted inside the returns.", label: "Inv2 expense ratio / yr", type: "percent", section: "Portfolio & taxes" },
  inv2_use_realized_gains_tax_system: { tip: "On: tax on sales (realized gains). Off: annual mark-to-market tax.", label: "Inv2 realized-gains tax", type: "toggle", section: "Portfolio & taxes" },
  inv2_realized_gains_tax_rate: { tip: "Tax on realized gains when selling asset 2.", label: "Inv2 realized tax rate", type: "percent", section: "Portfolio & taxes" },
  inv2_annual_tax_on_gains_rate: { tip: "Annual tax on positive market P&L (when not using realized taxation).", label: "Inv2 annual gains tax", type: "percent", section: "Portfolio & taxes" },
  inflation_rate_mean: { tip: "Mean annual inflation; drives expenses and indexed income.", label: "Inflation mean / yr", type: "percent", section: "Inflation" },
  inflation_rate_volatility: { tip: "Annual inflation volatility.", label: "Inflation volatility / yr", type: "percent", section: "Inflation" },
  equity_inflation_correlation: { tip: "Correlation between equity and inflation shocks (-1 to 1).", label: "Equity–inflation correlation", type: "number", section: "Inflation", step: 0.05 },
  num_simulations_main: { tip: "Paths for the final run (1000+; 10000+ for production).", label: "Final simulations", type: "int", section: "Simulation" },
  num_simulations_search: { tip: "Paths per probe during the working-months search.", label: "Search simulations", type: "int", section: "Simulation" },
  target_probability: { tip: "Required success probability the search must reach.", label: "Target success %", type: "number", section: "Simulation" },
  starting_working_months_search: { tip: "Lower bound for the search.", label: "Search start (months)", type: "int", section: "Simulation" },
  seed: { tip: "Fixes all randomness for reproducible runs; blank draws a fresh seed.", label: "Seed (blank = random)", type: "int-opt", section: "Simulation" },
  antithetic: { tip: "Variance reduction: pairs every path with a mirrored-shock twin. Unbiased; ~3x fewer paths for the same success-probability error in the 60-95% regime.", label: "Antithetic sampling", type: "toggle", section: "Simulation" },
  num_processes: { tip: "Accepted for config compatibility; the engine shards over devices.", label: "num_processes (compat)", type: "int-opt", section: "Simulation" },
};

const STREAM_FIELDS = {
  name: { label: "Name", type: "text" },
  monthly_amount_today: { label: "Monthly amount (today's $)", type: "money" },
  start_at_age: { label: "Starts at age", type: "number" },
  duration_years: { label: "Duration yrs (blank = forever)", type: "int-opt" },
  inflation_indexed: { label: "Inflation indexed", type: "toggle" },
  tax_rate: { label: "Tax rate", type: "percent" },
};

const SECTIONS = ["Scenario", "Finances", "Portfolio & taxes", "Inflation",
  "Other income", "Spending rule", "Market risk", "Longevity", "Simulation"];

// Guardrail fields live on the nested spending_guardrails object; values
// are already in percent units in the schema, so plain number inputs.
const GUARDRAIL_FIELDS = {
  upper_wr_pct: { label: "Cut when WR above (%)", type: "number", tip: "Withdrawal-rate guardrail: planned spending is cut when the year-start WR exceeds this." },
  lower_wr_pct: { label: "Raise when WR below (%)", type: "number", tip: "Planned spending rises when the year-start WR falls below this." },
  adjustment_pct: { label: "Adjustment step (%)", type: "number", tip: "Percent change applied to spending per trigger." },
  floor_pct: { label: "Spending floor (% of plan)", type: "number", tip: "Spending never falls below this share of the original plan." },
  cap_pct: { label: "Spending cap (% of plan)", type: "number", tip: "Spending never rises above this share of the original plan." },
};
const GUARDRAIL_DEFAULTS = {
  upper_wr_pct: 6, lower_wr_pct: 3, adjustment_pct: 10,
  floor_pct: 50, cap_pct: 200,
};

// Market-crash fields live on the nested market_crashes object.
const CRASH_FIELDS = {
  frequency_per_year: { label: "Crashes per year (expected)", type: "number", tip: "Expected crash count per year; each month crashes with probability this/12." },
  mean_drop_pct: { label: "Median drop (%)", type: "number", tip: "Median crash size as a percent drop (20 = the asset loses 20% in a median crash)." },
  size_volatility: { label: "Size dispersion (log σ)", type: "number", tip: "Spread of crash sizes around the median in log space; 0 = every crash is exactly the median drop." },
  inv2_beta: { label: "Asset-2 beta", type: "number", tip: "Fraction of the crash applied to investment 2 (0 = crashes hit investment 1 only)." },
};
const CRASH_DEFAULTS = {
  frequency_per_year: 0.25, mean_drop_pct: 20, size_volatility: 0.3,
  inv2_beta: 0,
};

// Longevity fields live on the nested longevity object (ages in years).
const LONGEVITY_FIELDS = {
  mode_age: { label: "Most likely age at death", type: "number", tip: "Gompertz modal age: the single most likely age to die (~86-90 in current annuitant tables)." },
  dispersion_years: { label: "Lifespan dispersion (years)", type: "number", tip: "Gompertz dispersion b (~9-11 for human mortality); larger = more lifespan uncertainty." },
  max_age: { label: "Maximum age", type: "number", tip: "Hard cap: lifetimes truncate at this age. Must exceed the modal age." },
};
const LONGEVITY_DEFAULTS = { mode_age: 87, dispersion_years: 10, max_age: 115 };

// --- tip balloon -----------------------------------------------------------
// One shared balloon, portaled to <body> so sidebar overflow never clips it.
// Hovering an ⓘ icon shows it; clicking pins it (click anywhere dismisses).
const tipBalloon = {
  el: null,
  pinnedBy: null,
  _ensure() {
    if (this.el) return this.el;
    this.el = document.createElement("div");
    this.el.className = "tip-balloon";
    this.el.setAttribute("role", "tooltip");
    document.body.appendChild(this.el);
    document.addEventListener("click", (e) => {
      if (this.pinnedBy && !this.el.contains(e.target) && e.target !== this.pinnedBy) {
        this.pinnedBy = null;
        this.hide();
      }
    });
    window.addEventListener("scroll", () => this.hide(true), true);
    return this.el;
  },
  show(anchor, text, pinned) {
    const el = this._ensure();
    el.textContent = text;
    el.classList.toggle("pinned", !!pinned);
    el.style.visibility = "hidden";
    el.classList.add("visible");
    // Position after layout: below the icon, clamped to the viewport,
    // flipped above when there is no room underneath.
    const a = anchor.getBoundingClientRect();
    const b = el.getBoundingClientRect();
    let left = Math.min(
      Math.max(6, a.left + a.width / 2 - b.width / 2),
      window.innerWidth - b.width - 6
    );
    let top = a.bottom + 6;
    if (top + b.height > window.innerHeight - 6) top = a.top - b.height - 6;
    el.style.left = `${Math.round(left + window.scrollX)}px`;
    el.style.top = `${Math.round(top + window.scrollY)}px`;
    el.style.visibility = "";
  },
  hide(force) {
    if (this.pinnedBy && !force) return;
    if (force) this.pinnedBy = null;
    if (this.el) this.el.classList.remove("visible", "pinned");
  },
};

function tipIcon(text) {
  const icon = document.createElement("button");
  icon.type = "button";
  icon.className = "tip-icon";
  icon.textContent = "?";
  icon.setAttribute("aria-label", "Help");
  icon.addEventListener("mouseenter", () => {
    if (!tipBalloon.pinnedBy) tipBalloon.show(icon, text, false);
  });
  icon.addEventListener("mouseleave", () => tipBalloon.hide());
  icon.addEventListener("click", (e) => {
    e.stopPropagation();
    if (tipBalloon.pinnedBy === icon) {
      tipBalloon.pinnedBy = null;
      tipBalloon.hide(true);
    } else {
      tipBalloon.pinnedBy = icon;
      tipBalloon.show(icon, text, true);
    }
  });
  return icon;
}

export class ConfigEditor {
  constructor(root, { onRun }) {
    this.root = root;
    this.onRun = onRun;
    this.config = null;
    this.defaultConfig = null;
    this.mode = "form";
    this.running = false;
  }

  // Deep copy of the scenario currently in the editor (form or JSON mode)
  // — the grid panel builds its base config from this.
  getConfig() {
    return this.config ? JSON.parse(JSON.stringify(this.config)) : null;
  }

  setDefault(config) {
    this.defaultConfig = JSON.parse(JSON.stringify(config));
    this.config = JSON.parse(JSON.stringify(config));
    this.render();
  }

  setRunning(running) {
    this.running = running;
    const btn = this.root.querySelector("#run-btn");
    if (btn) {
      btn.disabled = running;
      btn.textContent = running ? "Running…" : "Run simulation";
    }
  }

  // ---- input factories -------------------------------------------------
  _input(spec, value, onChange) {
    if (spec.type === "toggle") {
      const label = document.createElement("label");
      label.className = "toggle";
      const cb = document.createElement("input");
      cb.type = "checkbox";
      cb.checked = !!value;
      cb.onchange = () => onChange(cb.checked);
      label.appendChild(cb);
      label.appendChild(document.createTextNode(spec.label));
      return label;
    }
    const wrap = document.createElement("div");
    wrap.className = "unit-wrap";
    const input = document.createElement("input");
    input.type = spec.type === "text" ? "text" : "number";
    if (spec.type === "percent" || spec.type === "percent-opt") {
      input.step = "0.1";
      input.value = value === null || value === undefined ? "" : (value * 100).toFixed(4).replace(/\.?0+$/, "");
    } else if (spec.type === "int" || spec.type === "int-opt") {
      input.step = "1";
      input.value = value === null || value === undefined ? "" : value;
    } else {
      if (spec.step) input.step = spec.step;
      input.value = value === null || value === undefined ? "" : value;
    }
    // A cleared required field must NOT silently become 0 (zero expenses
    // would "succeed" with a nonsense scenario); restore the last valid
    // display instead. Only int-opt fields (duration: indefinite) accept
    // empty as a real value (null).
    let lastDisplay = input.value;
    input.onchange = () => {
      const raw = input.value.trim();
      if (spec.type === "text") return onChange(raw);
      if (raw === "") {
        if (spec.type === "int-opt" || spec.type === "percent-opt") {
          lastDisplay = "";
          return onChange(null);
        }
        input.value = lastDisplay;
        return;
      }
      const num = Number(raw);
      if (!Number.isFinite(num)) {
        input.value = lastDisplay;
        return;
      }
      lastDisplay = input.value;
      if (spec.type.startsWith("percent")) return onChange(num / 100);
      if (spec.type.startsWith("int")) {
        // Show the value actually committed: 10.7 rounds to 11 in config,
        // so the input must not keep displaying 10.7.
        const rounded = Math.round(num);
        input.value = String(rounded);
        lastDisplay = input.value;
        return onChange(rounded);
      }
      onChange(num);
    };
    wrap.appendChild(input);
    if (spec.type.startsWith("percent") || spec.type === "money") {
      const unit = document.createElement("span");
      unit.className = "unit";
      unit.textContent = spec.type === "money" ? "$" : "%";
      wrap.appendChild(unit);
    }
    return wrap;
  }

  _field(key, spec, value, onChange) {
    const field = document.createElement("div");
    field.className = "field" + (spec.wide ? " wide" : "");
    if (spec.type !== "toggle") {
      const label = document.createElement("label");
      label.textContent = spec.label;
      if (spec.tip) label.appendChild(tipIcon(spec.tip));
      field.appendChild(label);
    } else if (spec.tip) {
      field.title = spec.tip;
    }
    field.appendChild(this._input(spec, value, onChange));
    return field;
  }

  // ---- sections --------------------------------------------------------
  _guardrailsSection(body) {
    // Dynamic spending guardrails (engine extension): a toggle enables the
    // nested spending_guardrails object with sensible defaults; disabling
    // sets it back to null (the reference's fixed real spending).
    const enabled = !!this.config.spending_guardrails;
    const toggle = this._field(
      "spending_guardrails_enabled",
      { label: "Dynamic spending (guardrails)", type: "toggle",
        tip: "Guyton-Klinger style: at each retirement-year start, spending cuts or rises when the planned withdrawal rate crosses a band. Off = the fixed real spending the reference models." },
      enabled,
      (v) => {
        this.config.spending_guardrails = v ? { ...GUARDRAIL_DEFAULTS } : null;
        this.render();
      },
    );
    body.appendChild(toggle);
    if (!enabled) return;
    for (const [key, spec] of Object.entries(GUARDRAIL_FIELDS)) {
      body.appendChild(
        this._field(key, spec, this.config.spending_guardrails[key], (v) => {
          this.config.spending_guardrails[key] = v;
        })
      );
    }
  }

  _crashesSection(body) {
    // Market-crash jumps (engine extension): a toggle enables the nested
    // market_crashes object with sensible defaults; disabling sets it back
    // to null (the reference's pure-lognormal returns). The drift is
    // compensated, so crashes reshape risk without changing the mean.
    const enabled = !!this.config.market_crashes;
    const toggle = this._field(
      "market_crashes_enabled",
      { label: "Market crashes (jumps)", type: "toggle",
        tip: "Adds sudden-crash months on top of the lognormal returns (sequence-of-returns risk). The mean return stays exactly as configured; crashes only fatten the left tail." },
      enabled,
      (v) => {
        this.config.market_crashes = v ? { ...CRASH_DEFAULTS } : null;
        this.render();
      },
    );
    body.appendChild(toggle);
    if (!enabled) return;
    for (const [key, spec] of Object.entries(CRASH_FIELDS)) {
      body.appendChild(
        this._field(key, spec, this.config.market_crashes[key], (v) => {
          this.config.market_crashes[key] = v;
        })
      );
    }
  }

  _longevitySection(body) {
    // Stochastic lifespan (engine extension): a toggle enables the nested
    // longevity object with sensible defaults; disabling sets it back to
    // null (the reference's fixed retirement horizon). With the rule on,
    // success means "the money outlasted the owner" and the final balance
    // is the bequest at the plan horizon.
    const enabled = !!this.config.longevity;
    const toggle = this._field(
      "longevity_enabled",
      { label: "Stochastic lifespan (mortality)", type: "toggle",
        tip: "Each path draws a lifetime from a Gompertz mortality law conditioned on the retirement age. Spending stops with the owner (the estate stays invested), so success becomes 'the money outlasted the owner'. Off = the reference's fixed horizon must be funded in full." },
      enabled,
      (v) => {
        this.config.longevity = v ? { ...LONGEVITY_DEFAULTS } : null;
        this.render();
      },
    );
    body.appendChild(toggle);
    if (!enabled) return;
    for (const [key, spec] of Object.entries(LONGEVITY_FIELDS)) {
      body.appendChild(
        this._field(key, spec, this.config.longevity[key], (v) => {
          this.config.longevity[key] = v;
        })
      );
    }
  }

  _streamsSection(body) {
    const streams = this.config.other_income_streams || [];
    streams.forEach((stream, idx) => {
      const cardDiv = document.createElement("div");
      cardDiv.className = "stream-card";
      const head = document.createElement("div");
      head.className = "head";
      // textContent, never innerHTML: the name comes from user-loaded JSON.
      const title = document.createElement("b");
      title.textContent = stream.name || `Stream ${idx + 1}`;
      head.appendChild(title);
      const rm = document.createElement("button");
      rm.className = "btn small danger";
      rm.textContent = "Remove";
      rm.onclick = () => {
        streams.splice(idx, 1);
        this.render();
      };
      head.appendChild(rm);
      cardDiv.appendChild(head);
      for (const [key, spec] of Object.entries(STREAM_FIELDS)) {
        cardDiv.appendChild(
          this._field(key, spec, stream[key], (v) => {
            stream[key] = v;
            // Keep the card header in sync with the Name field.
            if (key === "name") title.textContent = v || `Stream ${idx + 1}`;
          })
        );
      }
      body.appendChild(cardDiv);
    });
    const add = document.createElement("button");
    add.className = "btn small secondary";
    add.textContent = "+ Add income stream";
    add.style.gridColumn = "1 / -1";
    add.onclick = () => {
      (this.config.other_income_streams ||= []).push({
        name: `Stream ${streams.length + 1}`,
        monthly_amount_today: 1000,
        start_at_age: 65,
        duration_years: null,
        inflation_indexed: true,
        tax_rate: 0.0,
      });
      this.render();
    };
    body.appendChild(add);
  }

  // ---- render ----------------------------------------------------------
  render() {
    const root = this.root;
    root.innerHTML = "";
    if (!this.config) {
      root.textContent = "Loading default configuration…";
      return;
    }

    const tabs = document.createElement("div");
    tabs.className = "mode-tabs";
    for (const m of ["form", "json"]) {
      const b = document.createElement("button");
      b.textContent = m === "form" ? "Form" : "JSON";
      if (m === this.mode) b.className = "active";
      b.onclick = () => {
        if (this.mode === "json" && m === "form" && !this._syncFromJson()) return;
        this.mode = m;
        this.render();
      };
      tabs.appendChild(b);
    }
    root.appendChild(tabs);

    if (this.mode === "json") {
      const ta = document.createElement("textarea");
      ta.id = "json-editor";
      ta.value = JSON.stringify(this.config, null, 2);
      root.appendChild(ta);
      this._jsonArea = ta;
    } else {
      // Open/closed state survives re-renders (stream add/remove, Reset,
      // tab switches) so the section being edited never snaps shut.
      this._openSections ||= new Set(["Scenario", "Finances"]);
      for (const section of SECTIONS) {
        const details = document.createElement("details");
        details.className = "section";
        details.open = this._openSections.has(section);
        details.addEventListener("toggle", () => {
          if (details.open) this._openSections.add(section);
          else this._openSections.delete(section);
        });
        const summary = document.createElement("summary");
        summary.textContent = section;
        details.appendChild(summary);
        const body = document.createElement("div");
        body.className = "body";
        if (section === "Other income") {
          this._streamsSection(body);
        } else if (section === "Spending rule") {
          this._guardrailsSection(body);
        } else if (section === "Market risk") {
          this._crashesSection(body);
        } else if (section === "Longevity") {
          this._longevitySection(body);
        } else {
          for (const [key, spec] of Object.entries(FIELDS)) {
            if (spec.section !== section) continue;
            body.appendChild(
              this._field(key, spec, this.config[key], (v) => { this.config[key] = v; })
            );
          }
        }
        details.appendChild(body);
        root.appendChild(details);
      }
    }

    const actions = document.createElement("div");
    actions.className = "editor-actions";
    const load = document.createElement("button");
    load.className = "btn small secondary";
    load.textContent = "Load JSON";
    load.onclick = () => this._loadFile();
    const save = document.createElement("button");
    save.className = "btn small secondary";
    save.textContent = "Save JSON";
    save.onclick = () => this._saveFile();
    const reset = document.createElement("button");
    reset.className = "btn small secondary";
    reset.textContent = "Reset";
    reset.onclick = () => {
      this.config = JSON.parse(JSON.stringify(this.defaultConfig));
      this.render();
    };
    actions.append(load, save, reset);
    root.appendChild(actions);

    const runRow = document.createElement("div");
    runRow.className = "run-row";
    const override = document.createElement("div");
    override.className = "field";
    override.innerHTML = `<label>Working months override (skip search)</label>`;
    const ovInput = document.createElement("input");
    ovInput.type = "number";
    ovInput.min = "0";
    ovInput.step = "1";
    ovInput.id = "override-input";
    // The typed override must survive re-renders — losing it silently
    // downgrades the next Run to a full search.
    ovInput.value = this._overrideValue || "";
    ovInput.oninput = () => { this._overrideValue = ovInput.value; };
    override.appendChild(ovInput);
    const run = document.createElement("button");
    run.className = "btn";
    run.id = "run-btn";
    run.textContent = this.running ? "Running…" : "Run simulation";
    run.disabled = this.running;
    run.onclick = () => {
      if (this.mode === "json" && !this._syncFromJson()) return;
      this.onRun(JSON.parse(JSON.stringify(this.config)), ovInput.value);
    };
    runRow.append(override, run);
    root.appendChild(runRow);

    this._errorBox = document.createElement("div");
    this._errorBox.className = "error-box";
    root.appendChild(this._errorBox);
  }

  showError(message) {
    if (this._errorBox) this._errorBox.textContent = message || "";
  }

  _syncFromJson() {
    try {
      this.config = ConfigEditor._parseConfigObject(this._jsonArea.value);
      this.showError("");
      return true;
    } catch (err) {
      this.showError(`Invalid JSON: ${err.message}`);
      return false;
    }
  }

  // Valid JSON whose root is not a plain object (null, [], "x", 5) would
  // brick the form renderer; reject it with a clear message instead.
  static _parseConfigObject(text) {
    const parsed = JSON.parse(text);
    if (parsed === null || typeof parsed !== "object" || Array.isArray(parsed)) {
      throw new Error("configuration root must be a JSON object");
    }
    return parsed;
  }

  _saveFile() {
    if (this.mode === "json" && !this._syncFromJson()) return;
    const blob = new Blob([JSON.stringify(this.config, null, 2)],
      { type: "application/json" });
    const a = document.createElement("a");
    a.href = URL.createObjectURL(blob);
    a.download = `${(this.config.scenario || "scenario").replace(/\W+/g, "_")}.json`;
    a.click();
    URL.revokeObjectURL(a.href);
  }

  _loadFile() {
    const input = document.createElement("input");
    input.type = "file";
    input.accept = "application/json";
    input.onchange = async () => {
      const file = input.files[0];
      if (!file) return;
      try {
        this.config = ConfigEditor._parseConfigObject(await file.text());
        this.showError("");
        this.render();
      } catch (err) {
        this.showError(`Could not load file: ${err.message}`);
      }
    };
    input.click();
  }
}
