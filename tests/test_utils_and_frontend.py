"""Coverage for profiling utilities, mesh helpers and frontend integrity."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np

from monte_carlo_retirement_tpu.parallel.mesh import (
    make_mesh,
    pad_to_devices,
    shard_paths,
)
from monte_carlo_retirement_tpu.utils.profiling import (
    device_timer,
    phase_timings,
    trace_to,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_timer_accumulates_phases():
    x = jnp.ones((64,))
    # Canonical pattern: assign the block's OUTPUT to the handle so the
    # timer blocks on the timed computation, not an input.
    with device_timer("unit-phase") as t:
        t.result = x * 2
    with device_timer("unit-phase") as t:
        t.result = x + 1
    stats = phase_timings()["unit-phase"]
    assert stats["calls"] >= 2
    assert stats["total_s"] >= 0.0
    assert stats["mean_ms"] >= 0.0


def test_trace_to_noop_without_dir():
    with trace_to(None):
        pass  # must not start the profiler


def test_shard_paths_places_leading_axis():
    mesh = make_mesh()
    n = pad_to_devices(100, len(jax.devices()))
    arr = shard_paths(mesh, jnp.arange(n, dtype=jnp.float32))
    assert len(arr.sharding.device_set) == len(jax.devices())
    np.testing.assert_allclose(np.asarray(arr), np.arange(n, dtype=np.float32))


def test_frontend_dom_contract():
    """Every element id the JS queries must exist in index.html, and every
    module referenced via import must ship."""
    html = open(os.path.join(ROOT, "frontend", "index.html")).read()
    js_dir = os.path.join(ROOT, "frontend", "js")
    sources = {
        fn: open(os.path.join(js_dir, fn)).read() for fn in os.listdir(js_dir)
    }
    queried = set()
    for src in sources.values():
        queried |= set(re.findall(r'getElementById\("([\w-]+)"\)', src))
    declared = set(re.findall(r'id="([\w-]+)"', html))
    for src in sources.values():
        # ids assigned dynamically (el.id = "...") or created inside JS
        # template strings (id="..." in innerHTML markup) count as declared.
        declared |= set(re.findall(r'\.id\s*=\s*"([\w-]+)"', src))
        declared |= set(re.findall(r'id="([\w-]+)"', src))
    missing = {i for i in queried if i not in declared}
    assert not missing, f"JS queries unknown ids: {missing}"

    for src in sources.values():
        for mod in re.findall(r'from "\./(\w+)\.js"', src):
            assert f"{mod}.js" in sources, f"missing module {mod}.js"
    assert 'src="js/app.js"' in html
    assert 'href="styles.css"' in html


def _frontend_sources():
    js_dir = os.path.join(ROOT, "frontend", "js")
    return {fn: open(os.path.join(js_dir, fn)).read() for fn in os.listdir(js_dir)}


def test_frontend_css_class_contract():
    """Every class the JS assigns (and index.html uses) must have a CSS rule,
    every cssVar() the charts read must be defined in both themes, and every
    import must name a real export. A rendered-browser check is impossible in
    this image (no browser, no node, no JS engine — see docs/NOTES.md), so
    the wiring is pinned statically."""
    sources = _frontend_sources()
    js = "\n".join(sources.values())
    html = open(os.path.join(ROOT, "frontend", "index.html")).read()
    css = open(os.path.join(ROOT, "frontend", "styles.css")).read()

    used = set()
    for m in re.finditer(r'className\s*=\s*"([^"${]+)"', js):
        used.update(m.group(1).split())
    for m in re.finditer(r'classList\.(?:add|toggle|remove)\(\s*"([\w-]+)"', js):
        used.add(m.group(1))
    for m in re.finditer(r'class="([^"${]+)"', html):
        used.update(m.group(1).split())
    # Only SELECTOR text counts as "defined": strip comments and rule
    # bodies first, so a dot-word inside a comment, url(x.png) or property
    # value cannot satisfy the contract.
    css_no_comments = re.sub(r"/\*.*?\*/", "", css, flags=re.S)
    selector_text = "\n".join(
        re.findall(r"(?:^|})([^{}]*)\{", css_no_comments, flags=re.S)
    )
    defined = set(re.findall(r"\.([a-zA-Z][\w-]*)", selector_text))
    missing = sorted(c for c in used if c not in defined)
    assert not missing, f"classes styled nowhere: {missing}"

    vars_used = set(re.findall(r'cssVar\(\s*"--([\w-]+)"', js))
    light = css.split("[data-theme")[0]
    # Concatenate EVERY [data-theme="dark"] block body (there may be more
    # than one; each body ends at its first closing brace).
    dark = "\n".join(
        m.group(1)
        for m in re.finditer(
            r'\[data-theme="dark"\][^{]*\{([^}]*)\}', css_no_comments
        )
    )
    for v in vars_used:
        assert f"--{v}:" in light, f"--{v} missing from light theme"
        assert f"--{v}:" in dark, f"--{v} missing from dark theme"

    for fname, src in sources.items():
        for m in re.finditer(r'import \{([^}]+)\} from "\./(\w+)\.js"', src):
            target = sources[f"{m.group(2)}.js"]
            exports = set(
                re.findall(
                    r"export (?:async )?(?:function|const|let|class) (\w+)", target
                )
            )
            for name in (x.strip().split(" as ")[0] for x in m.group(1).split(",")):
                if name:
                    assert name in exports, f"{fname}: {name} not exported by {m.group(2)}.js"


def test_frontend_field_access_matches_response_schema():
    """Every first-level property each view card reads off its payload
    argument must exist on the corresponding response schema — the static
    analogue of rendering the cards against a live result."""
    from monte_carlo_retirement_tpu.hosts import schemas

    views = _frontend_sources()["views.js"]

    card_schema = {
        # summaryCard takes the whole response and aliases `.summary` locally;
        # both levels are checked (the alias via the extra entry below).
        "summaryCard": (r"function summaryCard\((\w+)", schemas.SimulationResponse),
        "searchCurveCard": (r"function searchCurveCard\((\w+)", schemas.SearchCurveData),
        "withdrawalRateCard": (
            r"function withdrawalRateCard\((\w+)",
            schemas.WithdrawalRateData,
        ),
        "ruinCard": (r"function ruinCard\((\w+)", schemas.RuinHistogramData),
        "histogramCard": (r"function histogramCard\((\w+)", schemas.HistogramData),
        # trajectoryCard also takes the whole response (nominal/real toggle).
        "trajectoryCard": (
            r"function trajectoryCard\((\w+)",
            schemas.SimulationResponse,
        ),
    }
    bodies = re.split(r"\nexport function ", views)
    for card, (sig_re, model) in card_schema.items():
        body = next((b for b in bodies if b.startswith(card)), None)
        assert body is not None, f"{card} missing from views.js"
        m = re.search(sig_re, "function " + body)
        assert m, f"cannot parse {card} signature"
        param = m.group(1)
        fields = set(model.model_fields)
        accesses = set(re.findall(rf"\b{param}\.(\w+)", body))
        unknown = sorted(a for a in accesses if a not in fields)
        assert not unknown, f"{card} reads fields not in {model.__name__}: {unknown}"

    # The summary alias inside summaryCard reads SimulationSummary fields.
    body = next(b for b in bodies if b.startswith("summaryCard"))
    alias = re.search(r"const (\w+) = \w+\.summary;", body)
    assert alias, "summaryCard no longer aliases .summary — update this test"
    s_fields = set(schemas.SimulationSummary.model_fields)
    s_accesses = set(re.findall(rf"\b{alias.group(1)}\.(\w+)", body))
    unknown = sorted(a for a in s_accesses if a not in s_fields)
    assert not unknown, f"summaryCard reads unknown summary fields: {unknown}"


def test_frontend_binned_histogram_consumed():
    """The bounded-payload forms added for million-path runs must actually be
    consumed by the dashboard."""
    views = _frontend_sources()["views.js"]
    assert ".binned" in views or "binned" in views
    assert "year_counts" in views
    assert "bin_edges" in views


def test_compile_cache_integrity_sweep(tmp_path):
    """verify_compilation_cache deletes torn/corrupt persistent-cache entries
    (jax's file cache writes non-atomically; a killed process leaves a
    truncated file whose native deserialization SIGSEGVs — the sweep turns
    that into a recompile instead)."""
    from jax._src import compilation_cache as cc

    from monte_carlo_retirement_tpu.engine.runner import (
        verify_compilation_cache,
    )

    good = cc.compress_executable(
        cc.combine_executable_and_time(b"x" * 64, 123)
    )
    (tmp_path / "jit_good-cache").write_bytes(good)
    # Torn write: a prefix of a valid compressed frame.
    (tmp_path / "jit_torn-cache").write_bytes(good[: len(good) // 2])
    (tmp_path / "jit_torn-atime").write_bytes(b"\0" * 8)
    # Garbage bytes that are not a compressed frame at all.
    (tmp_path / "jit_junk-cache").write_bytes(b"not a zstd frame")
    # Valid frame holding no executable payload.
    (tmp_path / "jit_empty-cache").write_bytes(
        cc.compress_executable(b"\0\0\0\1")
    )
    # Non-entry files are ignored.
    (tmp_path / ".lockfile").write_bytes(b"")

    removed = verify_compilation_cache(str(tmp_path))
    assert removed == 3
    survivors = sorted(p.name for p in tmp_path.iterdir())
    assert survivors == [".lockfile", "jit_good-cache"]
    # Idempotent: a clean cache sweeps clean.
    assert verify_compilation_cache(str(tmp_path)) == 0


def test_compile_cache_put_is_atomic(tmp_path):
    """jax's LRUCache.put writes entries with a bare non-atomic
    write_bytes and no lock when eviction is disabled, so a concurrent
    reader (second server process, distributed worker, parallel test) can
    see a torn entry and crash natively deserializing it. The engine
    patches put to temp-file + os.replace; entries must appear complete,
    never be overwritten, and leave no temp litter."""
    from monte_carlo_retirement_tpu.engine.runner import (
        _make_cache_writes_atomic,
    )

    _make_cache_writes_atomic()
    from jax._src import compilation_cache as cc
    from jax._src import lru_cache as _lru

    assert getattr(_lru.LRUCache, "_mcrt_atomic_put", False)
    cache = _lru.LRUCache(str(tmp_path), max_size=-1)  # eviction disabled
    assert not cache.eviction_enabled
    payload = cc.compress_executable(
        cc.combine_executable_and_time(b"x" * 512, 42)
    )
    cache.put("jit_entry", payload)
    assert cache.get("jit_entry") == payload
    # Same-key put is a no-op (matches upstream semantics).
    cache.put("jit_entry", payload + b"tail")
    assert cache.get("jit_entry") == payload
    # No temp litter left behind.
    leftovers = [p.name for p in tmp_path.iterdir() if ".tmp" in p.name]
    assert leftovers == []
    # The integrity sweep ignores temp names even if a crash strands one:
    # only *-cache entries are swept.
    (tmp_path / ".1234.jit_x-cache.tmp").write_bytes(b"half a wri")
    from monte_carlo_retirement_tpu.engine.runner import (
        verify_compilation_cache,
    )

    assert verify_compilation_cache(str(tmp_path)) == 0
