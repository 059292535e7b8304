"""Results analysis: correlation tables, bootstrap distributions, plots.

Counterpart of ``nerf_qa_tpu/tools/plot_results.py``. Reference behavior:
the plot_results*.py family (SURVEY §2 #28) — merge results CSVs with IQA
metric score CSVs; per-subset (synthetic/real/all) |correlation| tables
(plot_results_test2_bt500.py:93-127); bootstrap resampling of
per-participant MOS (2000 samples) into violin plots of correlation
distributions (plot_results_test2_bootstrap2.py:123-156); LaTeX tables with
gold/silver/bronze highlighting (plot_results_bootstrapping.py:287-316);
scatter + logistic/linear regression figures
(plot_results_test2_bt500.py:145-241).

No pandas (the card's machine has none): rows come in through ``csv`` as
dicts, a table is a ``CorrelationTable`` (metric rows, named columns, a
float array with NaN for a missing cell), and bootstrap samples are a dict
of arrays. ``correlations.csv`` and ``results_table.tex`` are always
written; figures need ``--figures`` and matplotlib, and without matplotlib
``--figures`` exits naming it.

Usage:
  python -m nerf_qa_torch.tools.plot_results --results-csv scores_square.csv \\
      [--scores-csv extra.csv] [--metric-cols DISTS PSNR ...] \\
      [--output-dir analysis] [--figures]
"""
from __future__ import annotations

import argparse
import csv
import math
import os
from dataclasses import dataclass

import numpy as np

from nerf_qa_torch.eval.correlations import (
    REAL_SCENE_IDS,
    SYNTH_SCENE_IDS,
    compute_correlations,
)

MEDAL_COLORS = ("gold!30", "gray!30", "brown!30")


@dataclass
class CorrelationTable:
    """Rows ``index`` (metric names) by ``columns``, ``values`` (R, C)
    float64 with NaN where a subset had no correlation."""

    index: list[str]
    columns: list[str]
    values: np.ndarray

    def loc(self, metric: str, column: str) -> float:
        return float(self.values[self.index.index(metric), self.columns.index(column)])

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["metric", *self.columns])
            for name, row in zip(self.index, self.values):
                w.writerow([name, *("" if math.isnan(v) else repr(float(v)) for v in row)])

    def to_string(self, digits: int = 4) -> str:
        cells = [["metric", *self.columns]]
        cells += [[name, *("NaN" if math.isnan(v) else f"{v:.{digits}f}" for v in row)]
                  for name, row in zip(self.index, self.values)]
        widths = [max(len(r[i]) for r in cells) for i in range(len(cells[0]))]
        return "\n".join("  ".join(c.rjust(w) for c, w in zip(r, widths)) for r in cells)


def read_csv_rows(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _float(v) -> float:
    return math.nan if v in ("", None) else float(v)


def is_numeric_column(rows: list[dict], col: str) -> bool:
    """True when every cell parses as a number (empty cells are NaN), as
    pandas' reader types a numeric column."""
    for r in rows:
        v = r.get(col)
        if v in ("", None):
            continue
        try:
            float(v)
        except ValueError:
            return False
    return True


def column(rows: list[dict], col: str) -> np.ndarray:
    return np.array([_float(r.get(col)) for r in rows], np.float64)


def subset_correlation_table(
    rows: list[dict],
    metric_cols: list[str],
    target_col: str = "MOS",
    scene_col: str = "scene",
) -> CorrelationTable:
    """|PLCC|/|SRCC|/|KTCC| per metric for synthetic / real / combined
    subsets (plot_results_test2_bt500.py:93-127)."""
    subsets = {
        "synthetic": [r for r in rows if r.get(scene_col) in SYNTH_SCENE_IDS],
        "real": [r for r in rows if r.get(scene_col) in REAL_SCENE_IDS],
        "combined": rows,
    }
    table_rows = []
    for metric in metric_cols:
        row = {}
        for name, sub in subsets.items():
            if len(sub) > 1 and metric in sub[0]:
                corr = compute_correlations(column(sub, metric), column(sub, target_col))
                for k, v in corr.items():
                    row[f"{name}_{k}"] = abs(v)
        table_rows.append(row)
    columns: list[str] = []
    for row in table_rows:
        columns += [k for k in row if k not in columns]
    values = np.array([[row.get(c, math.nan) for c in columns] for row in table_rows],
                      np.float64).reshape(len(metric_cols), len(columns))
    return CorrelationTable(list(metric_cols), columns, values)


def bootstrap_correlations(
    pred: np.ndarray,
    participant_scores: np.ndarray,
    n_samples: int = 2000,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Bootstrap-resample participants, recompute MOS, correlate
    (plot_results_test2_bootstrap2.py:123-156). participant_scores:
    (n_videos, n_participants). Returns {'plcc','srcc','ktcc'} -> (n_samples,)."""
    rng = np.random.default_rng(seed)
    n_videos, n_part = participant_scores.shape
    out = {"plcc": [], "srcc": [], "ktcc": []}
    for _ in range(n_samples):
        pick = rng.integers(0, n_part, n_part)
        mos = participant_scores[:, pick].mean(axis=1)
        corr = compute_correlations(pred, mos)
        for k in out:
            out[k].append(corr[k])
    return {k: np.asarray(v) for k, v in out.items()}


def _rank_min(values: np.ndarray, ascending: bool) -> np.ndarray:
    """pandas' ``rank(method="min")``: NaN stays NaN, ties share the
    smallest rank."""
    ranks = np.full(values.shape, math.nan)
    ok = ~np.isnan(values)
    v = values[ok] if ascending else -values[ok]
    ranks[ok] = [1 + int(np.sum(v < x)) for x in v]
    return ranks


def latex_table(table: CorrelationTable, medals: bool = True,
                higher_better: bool = True) -> str:
    """LaTeX correlation table with gold/silver/bronze cell highlighting
    (plot_results_bootstrapping.py:287-316)."""
    cols = table.columns
    lines = [
        "\\begin{tabular}{l" + "c" * len(cols) + "}",
        "\\toprule",
        "Metric & " + " & ".join(c.replace("_", "\\_") for c in cols) + " \\\\",
        "\\midrule",
    ]
    ranks = np.stack([_rank_min(table.values[:, j], not higher_better)
                      for j in range(len(cols))], axis=1) if cols else None
    for i, metric in enumerate(table.index):
        cells = []
        for j in range(len(cols)):
            v = table.values[i, j]
            cell = f"{v:.4f}" if not math.isnan(v) else "--"
            if medals and not math.isnan(v):
                r = int(ranks[i, j])
                if r <= 3:
                    cell = f"\\cellcolor{{{MEDAL_COLORS[r - 1]}}}{cell}"
            cells.append(cell)
        name = str(metric).replace("_", "\\_")
        lines.append(f"{name} & " + " & ".join(cells) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(lines)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit("--figures needs matplotlib, which is not installed; "
                         "the tables are written without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def scatter_regression_figure(rows: list[dict], pred_col, target_col, scene_col,
                              out_path, regression: str = "logistic"):
    """Per-scene coloured scatter with a fitted regression curve
    (plot_results_test2_bt500.py:145-241 / vis.py:15-64)."""
    plt = _pyplot()
    from scipy.optimize import curve_fit

    fig, ax = plt.subplots(figsize=(4.8, 3.6))
    for scene in sorted({r[scene_col] for r in rows}):
        group = [r for r in rows if r[scene_col] == scene]
        ax.scatter(column(group, pred_col), column(group, target_col), s=14,
                   label=str(scene), alpha=0.8)
    x = column(rows, pred_col)
    y = column(rows, target_col)
    xs = np.linspace(x.min(), x.max(), 200)
    try:
        if regression == "logistic":
            def f(x, b1, b2, b3, b4):
                return (b1 - b2) / (1 + np.exp((x - b3) / np.abs(b4))) + b2

            p0 = [y.max(), y.min(), np.median(x), max(np.std(x), 1e-3)]
            params, _ = curve_fit(f, x, y, p0=p0, maxfev=20000)
            ax.plot(xs, f(xs, *params), "k--", lw=1)
        else:
            coef = np.polyfit(x, y, 1)
            ax.plot(xs, np.polyval(coef, xs), "k--", lw=1)
    except (RuntimeError, ValueError, np.linalg.LinAlgError):
        pass  # the scatter alone when the curve does not fit
    ax.set_xlabel(pred_col)
    ax.set_ylabel(target_col)
    ax.legend(fontsize=5, ncol=2)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def violin_figure(samples: dict[str, dict[str, np.ndarray]], metric: str, out_path):
    """Violin plot of bootstrap correlation distributions per method
    (plot_results_bootstrapping.py:174-262); ``samples[name]`` is
    ``bootstrap_correlations``' output."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(max(4, len(samples)), 3.2))
    names = list(samples)
    data = [np.abs(samples[n][metric]) for n in names]
    ax.violinplot(data, showmedians=True)
    ax.set_xticks(range(1, len(names) + 1))
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel(f"|{metric.upper()}|")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def merge_rows(rows: list[dict], extra: list[dict]) -> list[dict]:
    """The JAX tool's merge: an inner join on ``video_id`` when both
    tables have it (left order; a shared column gets pandas' ``_x`` /
    ``_y`` suffixes), else the columns side by side, row by row."""
    left = list(rows[0]) if rows else []
    right = list(extra[0]) if extra else []
    if "video_id" in left and "video_id" in right:
        shared = (set(left) & set(right)) - {"video_id"}

        def renamed(row, suffix):
            return {(f"{k}{suffix}" if k in shared else k): v for k, v in row.items()}

        by_id: dict[str, list[dict]] = {}
        for r in extra:
            by_id.setdefault(r["video_id"], []).append(r)
        return [{**renamed(r, "_x"), **renamed(e, "_y")}
                for r in rows for e in by_id.get(r["video_id"], [])]
    n = max(len(rows), len(extra))
    return [{**(rows[i] if i < len(rows) else dict.fromkeys(left, "")),
             **(extra[i] if i < len(extra) else dict.fromkeys(right, ""))}
            for i in range(n)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Results analysis and plots")
    p.add_argument("--results-csv", required=True,
                   help="per-video results (video_id, pred_score, mos, ...)")
    p.add_argument("--scores-csv", default=None,
                   help="optional per-video IQA metric columns to merge")
    p.add_argument("--scene-col", default="scene")
    p.add_argument("--target-col", default="MOS")
    p.add_argument("--metric-cols", nargs="*", default=None)
    p.add_argument("--output-dir", default="./analysis")
    p.add_argument("--figures", action="store_true")
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    rows = read_csv_rows(args.results_csv)
    if args.scores_csv:
        rows = merge_rows(rows, read_csv_rows(args.scores_csv))
    metric_cols = args.metric_cols or [
        c for c in (rows[0] if rows else [])
        if c not in (args.scene_col, args.target_col, "video_id")
        and is_numeric_column(rows, c)
    ]
    table = subset_correlation_table(rows, metric_cols, args.target_col,
                                     args.scene_col)
    table.write_csv(os.path.join(args.output_dir, "correlations.csv"))
    with open(os.path.join(args.output_dir, "results_table.tex"), "w") as f:
        f.write(latex_table(table))
    print(table.to_string())
    if args.figures:
        for col in metric_cols:
            scatter_regression_figure(
                rows, col, args.target_col, args.scene_col,
                os.path.join(args.output_dir, f"scatter_{col}.pdf"),
            )
        print("figures in", args.output_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
