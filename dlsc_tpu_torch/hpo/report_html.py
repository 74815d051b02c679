"""Interactive HTML study reports — self-contained SVG + vanilla JS.

The port's copy of ``dlsc_tpu/hpo/report_html.py``.

reference: scripts/analyze_study.py:183-216 writes five interactive plotly
HTML files (optimization history, param importances, parallel-coordinate,
contour, slice). plotly is not installed in this environment, so this
module renders the same five reports as dependency-free standalone HTML:
inline SVG marks + a small vanilla-JS layer for hover tooltips (every
point carries its trial params) and drag-brushing on the
parallel-coordinate axes. Open in any browser; no network access needed.

Used by ``scripts/analyze_study.py --html`` (PNG plots remain the
default output; both can be produced in one run).
"""

from __future__ import annotations

import html as _html
import math
from pathlib import Path
from typing import Any, Sequence

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font: 13px system-ui, sans-serif; margin: 24px; color: #222; }}
 h1 {{ font-size: 17px; }}
 .hint {{ color: #777; margin-bottom: 10px; }}
 svg {{ background: #fff; border: 1px solid #ddd; }}
 .pt {{ cursor: pointer; }}
 .pt:hover {{ stroke: #000; stroke-width: 1.5; }}
 .dim {{ opacity: 0.08; }}
 #tip {{ position: fixed; display: none; background: #fff; border: 1px solid
        #999; padding: 6px 8px; font-size: 12px; pointer-events: none;
        white-space: pre; box-shadow: 2px 2px 6px rgba(0,0,0,.2); }}
 .axis text {{ font-size: 11px; fill: #444; }}
 .axis line, .axis path {{ stroke: #888; }}
 .grid line {{ stroke: #eee; }}
</style></head><body>
<h1>{title}</h1>
<div class="hint">{hint}</div>
{body}
<div id="tip"></div>
<script>
var tip = document.getElementById('tip');
document.querySelectorAll('[data-tip]').forEach(function (el) {{
  el.addEventListener('mousemove', function (ev) {{
    tip.textContent = el.getAttribute('data-tip');
    tip.style.left = (ev.clientX + 14) + 'px';
    tip.style.top = (ev.clientY + 14) + 'px';
    tip.style.display = 'block';
  }});
  el.addEventListener('mouseleave', function () {{
    tip.style.display = 'none';
  }});
}});
{script}
</script></body></html>
"""


def _esc(s: Any) -> str:
    return _html.escape(str(s), quote=True)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.5g}"
    return str(v)


def _trial_tip(t: dict) -> str:
    lines = [f"trial #{t['number']}  value={_fmt(t['value'])}"]
    lines += [f"{k} = {_fmt(v)}" for k, v in sorted(t["params"].items())]
    return _esc("\n".join(lines))


def _lin(lo: float, hi: float, a: float, b: float):
    span = (hi - lo) or 1.0

    def f(v: float) -> float:
        return a + (v - lo) / span * (b - a)

    return f


def _ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / n
    mag = 10 ** math.floor(math.log10(raw))
    step = min(s * mag for s in (1, 2, 5, 10) if s * mag >= raw)
    t0 = math.ceil(lo / step) * step
    out = []
    t = t0
    while t <= hi + 1e-12 * abs(step):
        out.append(round(t, 10))
        t += step
    return out or [lo]


def _viridis(u: float) -> str:
    """Tiny viridis-like ramp (dark blue → teal → yellow), u in [0, 1]."""
    u = min(max(u, 0.0), 1.0)
    stops = [(68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98),
             (253, 231, 37)]
    x = u * (len(stops) - 1)
    i = min(int(x), len(stops) - 2)
    f = x - i
    c = [round(stops[i][j] + f * (stops[i + 1][j] - stops[i][j]))
         for j in range(3)]
    return f"rgb({c[0]},{c[1]},{c[2]})"


def _collect(trials) -> list[dict]:
    out = []
    for t in trials:
        if t.value is None:
            continue
        out.append({
            "number": t.number,
            "value": float(t.value),
            "state": str(getattr(t, "state", "")),
            "params": dict(t.params),
        })
    return out


def _svg_axes(W, H, L, R, T, B, xt, yt, xf, yf, xlabel, ylabel,
              xfmt=_fmt) -> str:
    parts = [f'<g class="grid">']
    for v in yt:
        y = yf(v)
        parts.append(f'<line x1="{L}" y1="{y:.1f}" x2="{W - R}" '
                     f'y2="{y:.1f}"/>')
    parts.append("</g>")
    parts.append('<g class="axis">')
    parts.append(f'<path d="M{L} {T} V{H - B} H{W - R}" fill="none"/>')
    for v in xt:
        x = xf(v)
        parts.append(f'<line x1="{x:.1f}" y1="{H - B}" x2="{x:.1f}" '
                     f'y2="{H - B + 4}"/>'
                     f'<text x="{x:.1f}" y="{H - B + 16}" '
                     f'text-anchor="middle">{_esc(xfmt(v))}</text>')
    for v in yt:
        y = yf(v)
        parts.append(f'<line x1="{L - 4}" y1="{y:.1f}" x2="{L}" '
                     f'y2="{y:.1f}"/>'
                     f'<text x="{L - 7}" y="{y + 4:.1f}" '
                     f'text-anchor="end">{_esc(_fmt(v))}</text>')
    parts.append(f'<text x="{(L + W - R) / 2:.0f}" y="{H - 4}" '
                 f'text-anchor="middle">{_esc(xlabel)}</text>')
    parts.append(f'<text x="12" y="{(T + H - B) / 2:.0f}" '
                 f'text-anchor="middle" transform="rotate(-90 12 '
                 f'{(T + H - B) / 2:.0f})">{_esc(ylabel)}</text>')
    parts.append("</g>")
    return "".join(parts)


def history_html(trials, direction: str = "maximize") -> str:
    """Optimization history: per-trial values + best-so-far staircase."""
    data = _collect(trials)
    W, H, L, R, T, B = 860, 420, 60, 20, 16, 44
    body = f'<svg width="{W}" height="{H}">'
    if data:
        xs = [d["number"] for d in data]
        ys = [d["value"] for d in data]
        xf = _lin(min(xs), max(xs), L, W - R)
        lo, hi = min(ys), max(ys)
        pad = (hi - lo) * 0.06 or 0.5
        yf = _lin(lo - pad, hi + pad, H - B, T)
        body += _svg_axes(W, H, L, R, T, B, _ticks(min(xs), max(xs)),
                          _ticks(lo - pad, hi + pad), xf, yf,
                          "trial number", "objective value")
        best = None
        pts = []
        better = (lambda a, b: a > b) if direction.startswith("max") \
            else (lambda a, b: a < b)
        for d in sorted(data, key=lambda d: d["number"]):
            if best is None or better(d["value"], best):
                best = d["value"]
            pts.append((xf(d["number"]), yf(best)))
        path = "M" + " L".join(f"{x:.1f} {y:.1f}" for x, y in pts)
        body += (f'<path d="{path}" fill="none" stroke="#d62728" '
                 f'stroke-width="2"/>')
        for d in data:
            body += (f'<circle class="pt" cx="{xf(d["number"]):.1f}" '
                     f'cy="{yf(d["value"]):.1f}" r="4" fill="#1f77b4" '
                     f'fill-opacity="0.75" data-tip="{_trial_tip(d)}"/>')
    body += "</svg>"
    return _PAGE.format(
        title="Optimization history", body=body, script="",
        hint="blue: trial values (hover for params) — red: best so far")


def importances_html(importances: dict[str, float],
                     method: str = "fANOVA") -> str:
    """Horizontal bar chart of parameter importances."""
    items = sorted(importances.items(), key=lambda kv: kv[1])
    W, L, R, bar, gap = 860, 230, 60, 24, 10
    H = 40 + len(items) * (bar + gap)
    mx = max((v for _, v in items), default=1.0) or 1.0
    body = f'<svg width="{W}" height="{H}">'
    for i, (k, v) in enumerate(items):
        y = 20 + i * (bar + gap)
        w = (W - L - R) * v / mx
        body += (
            f'<rect class="pt" x="{L}" y="{y}" width="{w:.1f}" '
            f'height="{bar}" fill="{_viridis(v / mx)}" '
            f'data-tip="{_esc(k)} = {v:.4f}"/>'
            f'<text x="{L - 6}" y="{y + bar - 7}" text-anchor="end" '
            f'font-size="12">{_esc(k)}</text>'
            f'<text x="{L + w + 5:.1f}" y="{y + bar - 7}" '
            f'font-size="12">{v:.3f}</text>')
    body += "</svg>"
    return _PAGE.format(title=f"Parameter importances ({method})",
                        body=body, script="",
                        hint="hover a bar for the exact value")


def _numeric_params(data: list[dict]) -> list[str]:
    names: dict[str, bool] = {}
    for d in data:
        for k, v in d["params"].items():
            ok = isinstance(v, (int, float)) and not isinstance(v, bool)
            names[k] = names.get(k, True) and ok
    return [k for k, ok in names.items() if ok]


def slice_html(trials) -> str:
    """Per-parameter slice scatter plots (value vs parameter)."""
    data = _collect(trials)
    names = _numeric_params(data)
    blocks = []
    W, H, L, R, T, B = 400, 300, 58, 14, 14, 44
    for name in sorted(names):
        pts = [d for d in data if name in d["params"]]
        if len(pts) < 2:
            continue
        xs = [float(d["params"][name]) for d in pts]
        ys = [d["value"] for d in pts]
        logx = min(xs) > 0 and max(xs) / min(xs) > 100
        txs = [math.log10(v) for v in xs] if logx else xs
        xf = _lin(min(txs), max(txs), L, W - R)
        lo, hi = min(ys), max(ys)
        pad = (hi - lo) * 0.07 or 0.5
        yf = _lin(lo - pad, hi + pad, H - B, T)
        xt = _ticks(min(txs), max(txs), 4)
        fmt = (lambda v: _fmt(10 ** v)) if logx else _fmt
        svg = f'<svg width="{W}" height="{H}">'
        svg += _svg_axes(W, H, L, R, T, B, xt,
                         _ticks(lo - pad, hi + pad, 4), xf, yf,
                         name + (" (log)" if logx else ""), "value", fmt)
        for d, tx in zip(pts, txs):
            svg += (f'<circle class="pt" cx="{xf(tx):.1f}" '
                    f'cy="{yf(d["value"]):.1f}" r="4" '
                    f'fill="{_viridis((d["value"] - lo) / ((hi - lo) or 1))}"'
                    f' data-tip="{_trial_tip(d)}"/>')
        svg += "</svg>"
        blocks.append(svg)
    return _PAGE.format(title="Slice plots", script="",
                        body="\n".join(blocks) or "<p>no numeric params</p>",
                        hint="objective value vs each numeric parameter "
                             "(hover for the full trial)")


def parallel_coordinate_html(trials) -> str:
    """Parallel-coordinate plot with drag-brushing on every axis."""
    data = _collect(trials)
    names = sorted(_numeric_params(data))
    axes = ["value"] + names
    W, H, T, B = max(760, 170 * len(axes)), 460, 40, 30
    step = (W - 120) / max(len(axes) - 1, 1)
    xpos = {a: 60 + i * step for i, a in enumerate(axes)}
    scales = {}
    for a in axes:
        vals = [d["value"] if a == "value" else float(d["params"][a])
                for d in data if a == "value" or a in d["params"]]
        if not vals:
            vals = [0.0, 1.0]
        lo, hi = min(vals), max(vals)
        pad = (hi - lo) * 0.05 or 0.5
        scales[a] = (lo - pad, hi + pad)
    lines = []
    vlo = min((d["value"] for d in data), default=0.0)
    vhi = max((d["value"] for d in data), default=1.0)
    for d in data:
        pts, vals = [], {}
        for a in axes:
            v = d["value"] if a == "value" else d["params"].get(a)
            if v is None:
                break
            lo, hi = scales[a]
            y = H - B - (float(v) - lo) / ((hi - lo) or 1) * (H - T - B)
            pts.append((xpos[a], y))
            vals[a] = float(v)
        else:
            path = "M" + " L".join(f"{x:.1f} {y:.1f}" for x, y in pts)
            col = _viridis((d["value"] - vlo) / ((vhi - vlo) or 1))
            payload = ",".join(f"{a}:{vals[a]!r}" for a in axes)
            lines.append(
                f'<path class="pt ln" d="{path}" fill="none" stroke="{col}" '
                f'stroke-width="1.6" stroke-opacity="0.75" '
                f'data-vals="{_esc(payload)}" data-tip="{_trial_tip(d)}"/>')
    axis_svg = []
    for a in axes:
        x = xpos[a]
        lo, hi = scales[a]
        axis_svg.append(
            f'<g class="axis"><line class="axline" data-axis="{_esc(a)}" '
            f'data-lo="{lo}" data-hi="{hi}" x1="{x:.1f}" y1="{T}" '
            f'x2="{x:.1f}" y2="{H - B}" stroke-width="6" '
            f'stroke="#bbb"/>'
            f'<text x="{x:.1f}" y="{T - 8}" text-anchor="middle">'
            f'{_esc(a)}</text>'
            f'<text x="{x:.1f}" y="{H - B + 16}" text-anchor="middle">'
            f'{_fmt(lo)}…{_fmt(hi)}</text></g>')
    body = (f'<svg id="pc" width="{W}" height="{H}">'
            + "".join(lines) + "".join(axis_svg) + "</svg>")
    script = """
var brushes = {};
var svg = document.getElementById('pc');
var H_T = %d, H_B = %d, HH = %d;
function applyBrushes() {
  document.querySelectorAll('.ln').forEach(function (ln) {
    var vals = {};
    ln.getAttribute('data-vals').split(',').forEach(function (kv) {
      var i = kv.lastIndexOf(':');
      vals[kv.slice(0, i)] = parseFloat(kv.slice(i + 1));
    });
    var keep = Object.keys(brushes).every(function (a) {
      var b = brushes[a];
      return vals[a] >= b[0] && vals[a] <= b[1];
    });
    ln.classList.toggle('dim', !keep);
  });
}
document.querySelectorAll('.axline').forEach(function (ax) {
  var a = ax.getAttribute('data-axis');
  var lo = parseFloat(ax.getAttribute('data-lo'));
  var hi = parseFloat(ax.getAttribute('data-hi'));
  function val(ev) {
    var y = ev.clientY - svg.getBoundingClientRect().top;
    var u = (HH - H_B - y) / (HH - H_T - H_B);
    return lo + Math.min(Math.max(u, 0), 1) * (hi - lo);
  }
  var y0 = null;
  ax.addEventListener('mousedown', function (ev) {
    y0 = val(ev); ev.preventDefault();
    function move(ev2) {
      var y1 = val(ev2);
      brushes[a] = [Math.min(y0, y1), Math.max(y0, y1)];
      ax.setAttribute('stroke', '#e6a700');
      applyBrushes();
    }
    function up() {
      window.removeEventListener('mousemove', move);
      window.removeEventListener('mouseup', up);
    }
    window.addEventListener('mousemove', move);
    window.addEventListener('mouseup', up);
  });
  ax.addEventListener('dblclick', function () {
    delete brushes[a]; ax.setAttribute('stroke', '#bbb'); applyBrushes();
  });
});
""" % (T, B, H)
    return _PAGE.format(
        title="Parallel coordinates", body=body, script=script,
        hint="drag along an axis to brush (filter) trials — double-click "
             "the axis to clear; color = objective value")


def contour_html(trials, importances: dict[str, float],
                 max_pairs: int = 3, bins: int = 12) -> str:
    """Binned 2-D heatmaps of the objective over the top numeric params."""
    data = _collect(trials)
    names = [n for n in sorted(importances, key=importances.get,
                               reverse=True) if n in _numeric_params(data)]
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    blocks = []
    W, H, L, R, T, B = 430, 380, 64, 14, 16, 46
    for a, b in pairs[:max_pairs]:
        pts = [d for d in data if a in d["params"] and b in d["params"]]
        if len(pts) < 4:
            continue
        ax = [float(d["params"][a]) for d in pts]
        bx = [float(d["params"][b]) for d in pts]
        cells: dict[tuple[int, int], list[float]] = {}
        alo, ahi, blo, bhi = min(ax), max(ax), min(bx), max(bx)
        for d, va, vb in zip(pts, ax, bx):
            i = min(int((va - alo) / ((ahi - alo) or 1) * bins), bins - 1)
            j = min(int((vb - blo) / ((bhi - blo) or 1) * bins), bins - 1)
            cells.setdefault((i, j), []).append(d["value"])
        vals = [sum(v) / len(v) for v in cells.values()]
        vlo, vhi = min(vals), max(vals)
        xf = _lin(0, bins, L, W - R)
        yf = _lin(0, bins, H - B, T)
        svg = f'<svg width="{W}" height="{H}">'
        for (i, j), vlist in cells.items():
            m = sum(vlist) / len(vlist)
            svg += (
                f'<rect class="pt" x="{xf(i):.1f}" y="{yf(j + 1):.1f}" '
                f'width="{xf(1) - xf(0):.1f}" height="{yf(0) - yf(1):.1f}" '
                f'fill="{_viridis((m - vlo) / ((vhi - vlo) or 1))}" '
                f'data-tip="{_esc(a)} ≈ {_fmt(alo + (i + .5) / bins * (ahi - alo))}&#10;'
                f'{_esc(b)} ≈ {_fmt(blo + (j + .5) / bins * (bhi - blo))}&#10;'
                f'mean value = {m:.4f} ({len(vlist)} trial(s))"/>')
        svg += _svg_axes(W, H, L, R, T, B,
                         [], [], xf, yf, a, b)
        svg += "</svg>"
        blocks.append(svg)
    return _PAGE.format(
        title="Contour (binned objective heatmaps)", script="",
        body="\n".join(blocks) or "<p>not enough numeric params</p>",
        hint="mean objective per parameter-bin cell for the most important "
             "parameter pairs (hover a cell)")


def write_html_reports(study, importances: dict[str, float],
                       out_dir: Path) -> list[Path]:
    """Write the five reference-parity interactive reports
    (reference scripts/analyze_study.py:183-216 file set)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    trials = study.trials
    direction = getattr(study, "direction", "maximize")
    files = {
        "optimization_history.html": history_html(trials, direction),
        "param_importances.html": importances_html(importances or {}),
        "parallel_coordinate.html": parallel_coordinate_html(trials),
        "contour.html": contour_html(trials, importances or {}),
        "slice.html": slice_html(trials),
    }
    out = []
    for name, content in files.items():
        p = out_dir / name
        p.write_text(content)
        out.append(p)
    return out
