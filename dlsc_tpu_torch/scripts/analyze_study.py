"""Study analytics with the port (the counterpart of ``scripts/analyze_study.py``).

    python -m dlsc_tpu_torch.scripts.analyze_study --list [--storage sqlite:///optuna_studies.db]
    python -m dlsc_tpu_torch.scripts.analyze_study STUDY_NAME [--storage ...] [--out DIR] \
        [--csv] [--html] [--no-plots]

Reads a study db written by either package (the same SQLite schema) and
reports trial-state stats, pruning-epoch stats, the best trial with its
learning curve and parameter importances: fANOVA (``hpo/fanova.py``, when
scikit-learn is there) and two dependency-light proxies (rank correlation,
binned-variance main effects). Writes ``<study>_summary.json``, the CSV
(``--csv`` or ``--export FILE``), the five HTML reports (``--html``) and,
when matplotlib is installed, the plots (optimization history,
importances, slice, parallel-coordinate, contour); without matplotlib it
prints that the plots were skipped.
"""

from __future__ import annotations

import argparse
import csv as _csv
import json
from pathlib import Path

import numpy as np

from dlsc_tpu_torch.hpo import StudyManager, TrialState
from dlsc_tpu_torch.hpo.fanova import fanova_importances


def param_importances(trials) -> dict[str, float]:
    """Rank-correlation importance proxy (fANOVA needs a forest; this is the
    dependency-free equivalent: squared Spearman correlation between each
    parameter and the objective, normalized)."""
    done = [t for t in trials if t.state == TrialState.COMPLETE and t.value is not None]
    if len(done) < 3:
        return {}
    names = sorted({k for t in done for k in t.params})
    values = np.asarray([t.value for t in done], dtype=float)
    rv = np.argsort(np.argsort(values))
    scores = {}
    for name in names:
        xs = []
        for t in done:
            v = t.params.get(name)
            if isinstance(v, str) or isinstance(v, bool):
                v = hash(str(v)) % 1000  # categorical: arbitrary but consistent
            xs.append(float(v) if v is not None else np.nan)
        xs = np.asarray(xs)
        ok = ~np.isnan(xs)
        if ok.sum() < 3 or np.std(xs[ok]) == 0:
            continue
        rx = np.argsort(np.argsort(xs[ok]))
        r = np.corrcoef(rx, rv[ok])[0, 1]
        scores[name] = float(r**2)
    total = sum(scores.values()) or 1.0
    return {k: v / total for k, v in sorted(scores.items(), key=lambda kv: -kv[1])}


def param_importances_binned(trials) -> dict[str, float]:
    """Binned-variance main-effect decomposition (closer to fANOVA than the
    rank proxy: captures non-monotonic effects): for each parameter, bin its
    values (quantile bins for numerics, one bin per category otherwise) and
    score the between-bin variance of the objective over the total variance.
    Interactions are still not captured (that genuinely needs a forest)."""
    done = [t for t in trials if t.state == TrialState.COMPLETE and t.value is not None]
    if len(done) < 4:
        return {}
    values = np.asarray([t.value for t in done], dtype=float)
    total_var = float(np.var(values))
    if total_var == 0:
        return {}
    names = sorted({k for t in done for k in t.params})
    scores = {}
    for name in names:
        raw = [t.params.get(name) for t in done]
        ok = np.asarray([v is not None for v in raw])
        if ok.sum() < 4:
            continue
        vals = values[ok]
        xs = [v for v in raw if v is not None]
        if any(isinstance(v, (str, bool)) for v in xs):
            bins = {v: i for i, v in enumerate(dict.fromkeys(map(str, xs)))}
            idx = np.asarray([bins[str(v)] for v in xs])
        else:
            x = np.asarray(xs, dtype=float)
            n_bins = min(8, max(2, len(x) // 3))
            edges = np.quantile(x, np.linspace(0, 1, n_bins + 1)[1:-1])
            idx = np.searchsorted(edges, x)
        between = 0.0
        for b in np.unique(idx):
            sel = idx == b
            between += sel.sum() * (vals[sel].mean() - vals.mean()) ** 2
        scores[name] = float(between / len(vals) / total_var)
    total = sum(scores.values()) or 1.0
    return {k: v / total for k, v in sorted(scores.items(), key=lambda kv: -kv[1])}


def analyze(study, out_dir: Path, export_csv: bool,
            csv_path: Path | None = None, make_plots: bool = True,
            make_html: bool = False) -> None:
    trials = study.trials
    states = {s: len(study.trials_by_state(s)) for s in
              (TrialState.COMPLETE, TrialState.PRUNED, TrialState.FAIL,
               TrialState.RUNNING)}
    print(f"study: {study.study_name} ({study.direction})")
    print(f"trials: {len(trials)} {states}")

    pruned = study.trials_by_state(TrialState.PRUNED)
    if pruned:
        epochs = [t.last_step for t in pruned if t.last_step is not None]
        if epochs:
            print(f"pruning epochs: mean={np.mean(epochs):.1f} "
                  f"median={np.median(epochs):.0f} min={min(epochs)} max={max(epochs)}")

    try:
        best = study.best_trial
    except ValueError:
        print("no completed trials yet")
        return
    print(f"best trial #{best.number}: value={best.value:.4f}")
    for k, v in best.params.items():
        print(f"    {k} = {v}")
    if best.intermediate_values:
        curve = [best.intermediate_values[s] for s in sorted(best.intermediate_values)]
        print(f"    learning curve ({len(curve)} points): "
              f"{', '.join(f'{v:.3f}' for v in curve[:12])}"
              + (" …" if len(curve) > 12 else ""))

    imps_fanova = fanova_importances(trials)
    if imps_fanova:
        print("parameter importances (fANOVA, random forest):")
        for k, v in imps_fanova.items():
            print(f"    {k}: {v:.3f}")
    imps = param_importances(trials)
    if imps:
        print("parameter importances (rank-correlation proxy):")
        for k, v in imps.items():
            print(f"    {k}: {v:.3f}")
    imps_binned = param_importances_binned(trials)
    if imps_binned:
        print("parameter importances (binned-variance main effects):")
        for k, v in imps_binned.items():
            print(f"    {k}: {v:.3f}")

    out_dir.mkdir(parents=True, exist_ok=True)
    if make_plots:
        _plots(study, imps_fanova or imps_binned or imps, out_dir)
    if make_html:
        from dlsc_tpu_torch.hpo.report_html import write_html_reports

        for pth in write_html_reports(
                study, imps_fanova or imps_binned or imps, out_dir):
            print(f"html → {pth}")
    if export_csv or csv_path is not None:
        path = csv_path or out_dir / f"{study.study_name}_trials.csv"
        names = sorted({k for t in trials for k in t.params})
        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            w.writerow(["number", "state", "value", *names])
            for t in trials:
                w.writerow([t.number, t.state, t.value,
                            *[t.params.get(n) for n in names]])
        print(f"csv → {path}")
    (out_dir / f"{study.study_name}_summary.json").write_text(
        json.dumps({**study.summary(), "importances_fanova": imps_fanova,
                    "importances": imps,
                    "importances_binned": imps_binned}, indent=2))


def _plots(study, imps, out_dir: Path) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("plots skipped: matplotlib is not installed")
        return
    done = [t for t in study.trials if t.value is not None]
    if done:
        fig, ax = plt.subplots(figsize=(9, 5))
        xs = [t.number for t in done]
        ys = [t.value for t in done]
        ax.scatter(xs, ys, s=14, label="trial value")
        best = (np.maximum if study.direction == "maximize" else np.minimum).accumulate(ys)
        ax.plot(xs, best, color="C1", label="best so far")
        ax.set_xlabel("trial"); ax.set_ylabel("objective")
        ax.set_title("Optimization history"); ax.legend()
        fig.savefig(out_dir / "optimization_history.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)
    if imps:
        fig, ax = plt.subplots(figsize=(8, 4))
        ks = list(imps)[::-1]
        ax.barh(ks, [imps[k] for k in ks])
        ax.set_title("Parameter importances")
        fig.savefig(out_dir / "param_importances.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)
    # slice plots per numeric parameter
    names = sorted({k for t in done for k in t.params})
    for name in names:
        pts = [(t.params[name], t.value) for t in done
               if name in t.params and not isinstance(t.params[name], (str, bool))]
        if len(pts) < 3:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.scatter(*zip(*pts), s=12)
        ax.set_xlabel(name); ax.set_ylabel("objective")
        ax.set_title(f"slice: {name}")
        fig.savefig(out_dir / f"slice_{name.replace('.', '_')}.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)
    _parallel_coordinate_plot(done, names, out_dir, plt)
    _contour_plots(done, imps, out_dir, plt)


def _parallel_coordinate_plot(done, names, out_dir: Path, plt) -> None:
    """Parallel-coordinate plot (reference: analyze_study.py:196-216 plotly
    equivalent): one polyline per completed trial over min-max-normalized
    parameter axes plus the objective axis, colored by objective value."""
    if len(done) < 2 or not names:
        return
    axes = [*names, "objective"]

    def axis_values(name):
        if name == "objective":
            return {t.number: float(t.value) for t in done}, False
        vals = {}
        is_cat = any(isinstance(t.params.get(name), (str, bool))
                     for t in done if name in t.params)
        if is_cat:
            cats = list(dict.fromkeys(
                str(t.params[name]) for t in done if name in t.params))
            for t in done:
                if name in t.params:
                    vals[t.number] = cats.index(str(t.params[name]))
        else:
            for t in done:
                if name in t.params:
                    vals[t.number] = float(t.params[name])
        return vals, is_cat

    cols = [axis_values(a)[0] for a in axes]
    norm_cols = []
    for col in cols:
        v = np.asarray(list(col.values()), dtype=float)
        lo, hi = float(v.min()), float(v.max())
        span = (hi - lo) or 1.0
        norm_cols.append({k: (x - lo) / span for k, x in col.items()})

    obj = cols[-1]
    o = np.asarray(list(obj.values()))
    olo, ohi = float(o.min()), float(o.max())
    ospan = (ohi - olo) or 1.0
    cmap = plt.get_cmap("viridis")

    fig, ax = plt.subplots(figsize=(max(8, 1.6 * len(axes)), 5))
    for t in done:
        ys = [nc.get(t.number) for nc in norm_cols]
        if any(y is None for y in ys):
            continue
        ax.plot(range(len(axes)), ys, alpha=0.6,
                color=cmap((float(t.value) - olo) / ospan))
    ax.set_xticks(range(len(axes)))
    ax.set_xticklabels(axes, rotation=30, ha="right", fontsize=8)
    ax.set_yticks([])
    ax.set_title("Parallel coordinates (color = objective)")
    fig.colorbar(plt.cm.ScalarMappable(
        norm=plt.Normalize(olo, ohi), cmap=cmap), ax=ax, label="objective")
    fig.savefig(out_dir / "parallel_coordinate.png", dpi=120,
                bbox_inches="tight")
    plt.close(fig)


def _contour_plots(done, imps, out_dir: Path, plt, max_pairs: int = 3) -> None:
    """Contour plots of the objective over the most important numeric
    parameter pairs (reference's plotly contour equivalent; tricontourf
    interpolates the scattered trial points)."""
    numeric = [n for n in (imps or {}) if sum(
        1 for t in done
        if n in t.params and not isinstance(t.params[n], (str, bool))) >= 4]
    pairs = [(a, b) for i, a in enumerate(numeric) for b in numeric[i + 1:]]
    for a, b in pairs[:max_pairs]:
        pts = [(float(t.params[a]), float(t.params[b]), float(t.value))
               for t in done if a in t.params and b in t.params
               and not isinstance(t.params[a], (str, bool))
               and not isinstance(t.params[b], (str, bool))]
        if len(pts) < 4:
            continue
        x, y, z = map(np.asarray, zip(*pts))
        if np.std(x) == 0 or np.std(y) == 0:
            continue
        fig, ax = plt.subplots(figsize=(6, 5))
        try:
            c = ax.tricontourf(x, y, z, levels=12, cmap="viridis")
            fig.colorbar(c, ax=ax, label="objective")
        except Exception:  # degenerate triangulation (collinear points)
            sc = ax.scatter(x, y, c=z, cmap="viridis")
            fig.colorbar(sc, ax=ax, label="objective")
        ax.scatter(x, y, s=10, c="white", edgecolors="black", linewidths=0.4)
        ax.set_xlabel(a); ax.set_ylabel(b)
        ax.set_title(f"contour: {a} × {b}")
        safe = f"{a}_{b}".replace(".", "_")
        fig.savefig(out_dir / f"contour_{safe}.png", dpi=120,
                    bbox_inches="tight")
        plt.close(fig)


def main(argv=None) -> None:
    # CLI mirrors reference scripts/analyze_study.py:277-315 (--study-name/-s,
    # --storage-path/-p, --plots, --export, --list); the positional study name
    # and --storage/--out/--csv spellings are kept as convenience aliases.
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("study_name_pos", nargs="?", metavar="study_name")
    p.add_argument("--study-name", "-s", dest="study_name")
    p.add_argument("--storage-path", "-p", "--storage", dest="storage",
                   default="sqlite:///optuna_studies.db",
                   help="SQLite path or sqlite:/// URI")
    p.add_argument("--out", default="outputs/study_analysis")
    p.add_argument("--plots", action="store_true",
                   help="generate visualization plots")
    p.add_argument("--no-plots", action="store_true",
                   help="skip plot generation (plots default on when neither "
                        "flag is given, matching prior behavior)")
    p.add_argument("--html", action="store_true",
                   help="also write the five interactive HTML reports "
                        "(self-contained SVG+JS — the reference's plotly "
                        "file set; dlsc_tpu_torch/hpo/report_html.py)")
    p.add_argument("--export", metavar="CSV",
                   help="export trials to this CSV file")
    p.add_argument("--csv", action="store_true",
                   help="export trials CSV into the output dir")
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)

    storage = args.storage
    if "://" not in storage:  # reference passes a bare .db path
        storage = f"sqlite:///{storage}"
    name = args.study_name or args.study_name_pos
    mgr = StudyManager(name or "", storage)
    if args.list or not name:
        for s in mgr.list_studies():
            print(f"  {s['study_name']}: {s['n_trials']} trials ({s['direction']})")
        return
    study = mgr.load_study()
    make_plots = not args.no_plots
    analyze(study, Path(args.out), args.csv,
            csv_path=Path(args.export) if args.export else None,
            make_plots=make_plots, make_html=args.html)


if __name__ == "__main__":
    main()
