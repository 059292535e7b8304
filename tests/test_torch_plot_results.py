"""``tools/plot_results`` of the port (no pandas) against the JAX tool on
the CPU: the subset correlation table, the LaTeX table with its medals, the
bootstrap correlations, the merge of a scores CSV, the CLI's
``correlations.csv`` and ``results_table.tex`` from the same CSVs, and
``--figures``, which writes the scatter plots where matplotlib is installed
and exits naming it where it is not.

Tolerance: the correlations come out of the same scipy calls on columns
parsed by Python's ``float`` here and by pandas' parser in JAX, which may
land an ulp apart, so the tables are held to rel 1e-14 and the LaTeX text
(four decimals) equal.

The JAX tool's CLI picks metric columns with ``np.issubdtype`` of each
pandas dtype, which raises on a text column under pandas 3's string dtype;
its CSVs here hold no text column but ``scene`` (the port's picks skip a
text column, ``test_cli_skips_text_columns``)."""
import csv
import math
import sys

import numpy as np
import pandas as pd
import pytest

from nerf_qa_torch.tools import plot_results as tplot
from nerf_qa_tpu.tools import plot_results as jplot

SCENES = ("lego", "ship", "drums", "truck", "room", "horns")
RTOL = 1e-14


def _rows(n=24, seed=0, with_nan=False):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        mos = float(rng.uniform(1, 5))
        rows.append({
            "video_id": str(i),
            "scene": SCENES[i % len(SCENES)],
            "MOS": repr(mos),
            "ours": repr(mos + float(rng.normal(0, 0.3))),
            "psnr": repr(mos * 2 + float(rng.normal(0, 1.5))),
            "ssim": "" if with_nan and i == 3 else repr(-mos + float(rng.normal(0, 2.0))),
        })
    return rows


def _write(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    return str(path)


def _assert_same_table(got, want: pd.DataFrame):
    assert got.index == list(want.index)
    assert got.columns == list(want.columns)
    np.testing.assert_allclose(got.values, want.to_numpy(np.float64), rtol=RTOL)


@pytest.mark.parametrize("with_nan", [False, True])
def test_subset_correlation_table_matches_jax(with_nan, tmp_path):
    rows = _rows(with_nan=with_nan)
    df = pd.read_csv(_write(tmp_path / "r.csv", rows))
    cols = ["ours", "psnr", "ssim", "absent"]
    got = tplot.subset_correlation_table(rows, cols)
    want = jplot.subset_correlation_table(df, cols)
    _assert_same_table(got, want)
    assert got.loc("ours", "combined_plcc") > 0.9
    assert math.isnan(got.loc("absent", "combined_plcc"))


@pytest.mark.parametrize("higher_better", [True, False])
def test_latex_table_matches_jax(higher_better, tmp_path):
    rows = _rows(with_nan=True)
    df = pd.read_csv(_write(tmp_path / "r.csv", rows))
    cols = ["ours", "psnr", "ssim", "absent"]
    tex = tplot.latex_table(tplot.subset_correlation_table(rows, cols),
                            higher_better=higher_better)
    assert tex == jplot.latex_table(jplot.subset_correlation_table(df, cols),
                                    higher_better=higher_better)
    assert "\\cellcolor{gold!30}" in tex and "\\bottomrule" in tex


def test_rank_breaks_ties_to_the_smallest_rank():
    v = np.array([0.5, np.nan, 0.9, 0.5, 0.1])
    np.testing.assert_array_equal(
        tplot._rank_min(v, ascending=False),
        pd.Series(v).rank(ascending=False, method="min").to_numpy())


def test_bootstrap_correlations_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 1, 10)
    participants = pred[:, None] * 5 + rng.normal(0, 0.3, (10, 7))
    got = tplot.bootstrap_correlations(pred, participants, n_samples=50, seed=3)
    want = jplot.bootstrap_correlations(pred, participants, n_samples=50, seed=3)
    assert list(got) == list(want.columns)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].to_numpy())
    assert got["plcc"].mean() > 0.8


@pytest.mark.parametrize("merge", ["video_id", "side_by_side"])
def test_cli_matches_jax(merge, tmp_path):
    rows = _rows(with_nan=True)
    extra = [{"video_id": r["video_id"], "lpips": repr(float(i) * 0.01),
              "psnr": r["psnr"]} for i, r in enumerate(rows)][::-1]
    if merge == "side_by_side":
        # no shared column: the JAX tool's pd.concat would hold two "psnr"
        # columns, and picking metric columns raises on them
        extra = [{"lpips": e["lpips"]} for e in extra]
    results = _write(tmp_path / "results.csv", rows)
    scores = _write(tmp_path / "scores.csv", extra)
    outs = {}
    for pkg, main in (("jax", jplot.main), ("port", tplot.main)):
        outs[pkg] = tmp_path / pkg
        main(["--results-csv", results, "--scores-csv", scores,
              "--output-dir", str(outs[pkg])])
    got = pd.read_csv(outs["port"] / "correlations.csv", index_col=0)
    want = pd.read_csv(outs["jax"] / "correlations.csv", index_col=0)
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=RTOL)
    assert ((outs["port"] / "results_table.tex").read_text()
            == (outs["jax"] / "results_table.tex").read_text())
    expected = {"video_id": ["ours", "psnr_x", "ssim", "lpips", "psnr_y"],
                "side_by_side": ["ours", "psnr", "ssim", "lpips"]}[merge]
    assert list(got.index) == expected


def test_cli_skips_text_columns(tmp_path, capsys):
    rows = [dict(r, method="nerfacto" if i % 2 else "instant-ngp")
            for i, r in enumerate(_rows())]
    tplot.main(["--results-csv", _write(tmp_path / "r.csv", rows),
                "--output-dir", str(tmp_path / "out")])
    got = pd.read_csv(tmp_path / "out" / "correlations.csv", index_col=0)
    assert list(got.index) == ["ours", "psnr", "ssim"]
    assert "metric" in capsys.readouterr().out


def test_merge_rows_inner_join_keeps_left_order():
    left = [{"video_id": v, "a": str(i)} for i, v in enumerate("3120")]
    right = [{"video_id": v, "a": "r" + v, "b": "x"} for v in "0123" if v != "2"]
    got = tplot.merge_rows(left, right)
    want = pd.DataFrame(left).merge(pd.DataFrame(right), on="video_id")
    assert got == want.to_dict("records")


def test_figures_need_matplotlib(tmp_path, monkeypatch):
    results = _write(tmp_path / "results.csv", _rows())
    pytest.importorskip("matplotlib")
    tplot.main(["--results-csv", results, "--output-dir", str(tmp_path / "fig"),
                "--metric-cols", "ours", "--figures"])
    assert (tmp_path / "fig" / "scatter_ours.pdf").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        tplot.main(["--results-csv", results, "--output-dir", str(tmp_path / "nofig"),
                    "--metric-cols", "ours", "--figures"])
    # the tables are written before the figures are tried
    assert (tmp_path / "nofig" / "correlations.csv").exists()
