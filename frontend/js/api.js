// API client: REST + SSE streaming against the simulation server.
// Contract: GET /api/config/default, POST /api/validate, POST
// /api/simulate/stream with SSE frames "data: {json}\n\n" and event types
// phase / search_iter / search_refining / search_complete / result / error.

const BASE = "";

// Single definition of "an override was supplied" — app.js uses it to pick
// the initial progress phase and this module uses it to build the request;
// the two must never disagree.
export function hasOverride(value) {
  return value !== null && value !== undefined && value !== "";
}

// Error bodies are JSON {"detail": ...} (the reference server's FastAPI
// shape, which this server mirrors); fall back to the raw text for any
// other origin (proxies, crashes).
async function errorDetail(resp) {
  let text;
  try {
    text = await resp.text();
  } catch {
    return `HTTP ${resp.status}`;
  }
  try {
    const parsed = JSON.parse(text);
    if (parsed && typeof parsed.detail === "string") return parsed.detail;
  } catch {
    // not JSON — use the raw body
  }
  return text || `HTTP ${resp.status}`;
}

export async function getDefaultConfig() {
  const resp = await fetch(`${BASE}/api/config/default`);
  if (!resp.ok) throw new Error(`default config: HTTP ${resp.status}`);
  return resp.json();
}

// Discovery for the analysis panels: the config fields the sensitivity /
// optimize endpoints accept (with hard bounds), the optimizer objectives,
// and the default tornado set.
export async function getAnalysisMeta() {
  const resp = await fetch(`${BASE}/api/analysis/meta`);
  if (!resp.ok) throw new Error(`analysis meta: HTTP ${resp.status}`);
  return resp.json();
}

export async function validateConfig(config) {
  const resp = await fetch(`${BASE}/api/validate`, {
    method: "POST",
    headers: { "content-type": "application/json" },
    body: JSON.stringify({ config }),
  });
  if (!resp.ok) throw new Error(await errorDetail(resp));
  return resp.json();
}

// Run a simulation over SSE; callbacks: onProgress(event), onResult(data),
// onError(message).
export async function runSimulationStream(
  config,
  workingMonthsOverride,
  handlers,
) {
  const body = { config };
  if (hasOverride(workingMonthsOverride)) {
    const v = Number(workingMonthsOverride);
    if (!Number.isInteger(v) || v < 0) {
      handlers.onError("Working-months override must be a nonnegative integer.");
      return;
    }
    body.working_months_override = v;
  }
  return streamPost(`${BASE}/api/simulate/stream`, body, handlers);
}

// Run a scenario grid over SSE: body = {config, variants, working_months,
// num_paths?, chunk_size?}; progress events are grid_chunk {done, total}.
export async function runGridStream(body, handlers) {
  return streamPost(`${BASE}/api/grid/stream`, body, handlers);
}

// Optimize one config field over SSE: body = {config, working_months,
// param, lo?, hi?, num_paths?, points?, rounds?, objective?}; progress
// events are grid_chunk {done, total} and optimize_round {round, rounds,
// best_value, best_objective, interval}.
export async function runOptimizeStream(body, handlers) {
  return streamPost(`${BASE}/api/optimize/stream`, body, handlers);
}

// Run a sensitivity analysis: body = {config, working_months, params?,
// num_paths?}. Plain POST — kept for API parity with scripted clients.
export async function runSensitivity(body) {
  const resp = await fetch(`${BASE}/api/sensitivity`, {
    method: "POST",
    headers: { "content-type": "application/json" },
    body: JSON.stringify(body),
  });
  if (!resp.ok) throw new Error(await errorDetail(resp));
  return resp.json();
}

// Sensitivity over SSE (what the panel uses): the 1+2K probe rows run as
// chunked device dispatches, so progress events are grid_chunk
// {done, total} plus a phase event before the optional AD pass.
export async function runSensitivityStream(body, handlers) {
  return streamPost(`${BASE}/api/sensitivity/stream`, body, handlers);
}

// Shared SSE-over-POST transport: frames "data: {json}\n\n", terminal event
// type result|error; every transport failure routes through onError.
async function streamPost(url, body, { onProgress, onResult, onError }) {
  let resp;
  try {
    resp = await fetch(url, {
      method: "POST",
      headers: { "content-type": "application/json" },
      body: JSON.stringify(body),
    });
  } catch (err) {
    onError(`Network error: ${err.message}`);
    return;
  }
  if (!resp.ok) {
    onError(await errorDetail(resp));
    return;
  }

  // Everything past the headers must route failures through onError: a
  // dropped connection mid-stream or a truncated frame would otherwise
  // reject out of this function and strand the caller's running state.
  // Exceptions raised by the caller's OWN callbacks are re-thrown — those
  // are caller bugs to surface, not stream errors. `inCallback` is how the
  // two are told apart (a transport failure after the terminal frame is
  // neither: the result was already delivered, so it is ignored).
  const reader = resp.body.getReader();
  const decoder = new TextDecoder();
  let buffer = "";
  let sawTerminal = false;
  let inCallback = false;
  try {
    for (;;) {
      const { value, done } = await reader.read();
      if (done) break;
      buffer += decoder.decode(value, { stream: true });
      let idx;
      while ((idx = buffer.indexOf("\n\n")) >= 0) {
        const frame = buffer.slice(0, idx);
        buffer = buffer.slice(idx + 2);
        const line = frame.trim();
        if (!line.startsWith("data: ")) continue;
        const event = JSON.parse(line.slice(6));
        inCallback = true;
        if (event.type === "result") {
          sawTerminal = true;
          onResult(event.data);
        } else if (event.type === "error") {
          sawTerminal = true;
          onError(event.message);
        } else {
          onProgress(event);
        }
        inCallback = false;
      }
    }
  } catch (err) {
    // Release the connection: the server may keep computing for minutes,
    // and orphaned streams count against the browser's per-host cap.
    try { reader.cancel(); } catch { /* already closed */ }
    if (inCallback) throw err;
    if (!sawTerminal) onError(`Stream failed: ${err.message}`);
    return;
  }
  if (!sawTerminal) onError("Stream ended without a result.");
}
