"""fANOVA parameter importances (random-forest functional ANOVA).

The port's copy of ``dlsc_tpu/hpo/fanova.py``. scikit-learn's forest is
imported where it is used: without it (the card's machine has none) the
importances are empty and ``analyze_study`` reports its proxies.

Real fANOVA in the sense of Hutter, Hoos & Leyton-Brown (2014), the same
algorithm optuna's ``FanovaImportanceEvaluator`` wraps (reference:
scripts/analyze_study.py:167-180 calls
``optuna.importance.get_param_importances`` whose default evaluator is
fANOVA): fit a random forest on (hyperparameters → objective), then, per
tree, decompose the variance of the piecewise-constant tree function into
single-parameter main effects by exact marginalization over the tree's leaf
partition. The importance of parameter *j* is the mean over trees of
``Var_j(tree) / Var_total(tree)``, renormalized over parameters.

Unlike the binned-variance and rank-correlation proxies shipped alongside
(scripts/analyze_study.py), this is the genuine article: the forest models
interactions, and the per-tree marginalization integrates them out exactly
(not by sample averaging), so a parameter that only matters in combination
with another still shows up through the trees that split on it.

Matches optuna's evaluator defaults: ``n_trees=64, max_depth=64, seed=0``;
trials considered are COMPLETE trials over the *intersection* search space
(parameters present in every completed trial), as optuna's
``intersection_search_space`` does. Numeric parameters are min-max scaled to
[0, 1]; categoricals are integer-coded with domain [-0.5, k-0.5] so a tree
split between adjacent codes halves the category mass exactly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fanova_importances"]


def _encode(trials, names):
    """Column-encode trial params into an (n_trials, n_params) matrix scaled
    so every feature's domain is [0, 1] (categoricals: k codes mapped onto
    cell centers (i+0.5)/k, so a split between adjacent codes halves the
    category mass exactly)."""
    cols = []
    for name in names:
        raw = [t.params[name] for t in trials]
        if any(isinstance(v, (str, bool)) for v in raw):
            cats = list(dict.fromkeys(str(v) for v in raw))
            # integer codes centered on cells of width 1/k: code i -> (i+.5)/k
            k = len(cats)
            x = np.asarray([(cats.index(str(v)) + 0.5) / k for v in raw])
        else:
            x = np.asarray(raw, dtype=float)
            lo, hi = float(x.min()), float(x.max())
            x = (x - lo) / ((hi - lo) or 1.0)
        cols.append(x)
    return np.stack(cols, axis=1)


def _tree_leaf_boxes(tree, n_features):
    """Walk a fitted sklearn tree; yield (lower, upper, value) per leaf with
    bounds clipped to the unit box."""
    t = tree.tree_
    boxes = []
    stack = [(0, np.zeros(n_features), np.ones(n_features))]
    while stack:
        node, lo, hi = stack.pop()
        f = t.feature[node]
        if f < 0:  # leaf
            boxes.append((lo, hi, float(t.value[node, 0, 0])))
            continue
        thr = t.threshold[node]
        lo_l, hi_l = lo.copy(), hi.copy()
        hi_l[f] = min(hi_l[f], thr)
        lo_r, hi_r = lo.copy(), hi.copy()
        lo_r[f] = max(lo_r[f], thr)
        stack.append((t.children_left[node], lo_l, hi_l))
        stack.append((t.children_right[node], lo_r, hi_r))
    return boxes


def _tree_main_effects(boxes, n_features):
    """Exact single-parameter variance decomposition of one tree.

    The tree function is constant on axis-aligned boxes tiling [0,1]^d. Its
    marginal along feature j is piecewise constant on the intervals cut by
    the tree's split points on j; both the marginal and its variance are
    computed exactly from box geometry (no Monte Carlo).
    """
    widths = np.asarray([hi - lo for lo, hi, _ in boxes])  # (L, d)
    vals = np.asarray([v for _, _, v in boxes])
    w_all = widths.prod(axis=1)                            # leaf box volumes
    mean = float((w_all * vals).sum())                     # ∫ f = Σ vol·v
    total_var = float((w_all * (vals - mean) ** 2).sum())
    if total_var <= 0:
        return np.zeros(n_features), 0.0

    lows = np.asarray([lo for lo, _, _ in boxes])
    his = np.asarray([hi for _, hi, _ in boxes])
    var_j = np.zeros(n_features)
    for j in range(n_features):
        cuts = np.unique(np.concatenate([[0.0, 1.0], lows[:, j], his[:, j]]))
        seg_lo, seg_hi = cuts[:-1], cuts[1:]
        seg_w = seg_hi - seg_lo
        # weight of each leaf with feature j marginalized out
        w_rest = np.where(widths[:, j] > 0, w_all / np.where(
            widths[:, j] > 0, widths[:, j], 1.0), 0.0)
        # membership: leaf covers segment iff its j-interval contains it
        mid = (seg_lo + seg_hi) / 2.0
        cover = (lows[:, j][:, None] <= mid[None, :]) & (
            mid[None, :] < his[:, j][:, None])             # (L, S)
        marg = (cover * (w_rest * vals)[:, None]).sum(axis=0)
        var_j[j] = float((seg_w * (marg - mean) ** 2).sum())
    return var_j, total_var


def fanova_importances(trials, n_trees: int = 64, max_depth: int = 64,
                       seed: int = 0) -> dict[str, float]:
    """fANOVA main-effect importances over a study's completed trials.

    Returns {param: importance} normalized to sum 1, sorted descending;
    empty dict when fewer than 4 complete trials or sklearn is unavailable
    (callers fall back to the proxies).
    """
    try:
        from sklearn.ensemble import RandomForestRegressor
    except Exception:  # pragma: no cover - sklearn is installed here
        return {}
    done = [t for t in trials
            if getattr(t, "state", "COMPLETE") == "COMPLETE"
            and t.value is not None]
    if len(done) < 4:
        return {}
    # intersection search space (optuna semantics)
    names = sorted(set.intersection(*(set(t.params) for t in done)))
    if not names:
        return {}
    X = _encode(done, names)
    y = np.asarray([t.value for t in done], dtype=float)
    if float(np.var(y)) == 0.0:
        return {}
    forest = RandomForestRegressor(n_estimators=n_trees, max_depth=max_depth,
                                   random_state=seed)
    forest.fit(X, y)
    fractions = np.zeros(len(names))
    n_used = 0
    for est in forest.estimators_:
        boxes = _tree_leaf_boxes(est, len(names))
        var_j, total = _tree_main_effects(boxes, len(names))
        if total <= 0:
            continue
        fractions += var_j / total
        n_used += 1
    if n_used == 0:
        return {}
    fractions /= n_used
    s = fractions.sum() or 1.0
    imp = {n: float(f / s) for n, f in zip(names, fractions)}
    return dict(sorted(imp.items(), key=lambda kv: -kv[1]))
