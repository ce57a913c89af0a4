"""Figure generation from benchmark CSVs.

The reference drives its figures from CSV artifacts
(scripts-part1/part1_plot_results.jl, scripts-part2/multigrid_plots.jl);
this pins the same property — every figure family regenerates from a
results directory alone — on small synthetic tables written here.
"""

import csv

import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from fpr_tpu.plotting import plots


def _write(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


TABLES = {
    "diffusion_scaling.csv": [
        dict(mode="strong", devices=d, throughput_gbs=100.0 * d,
             performance_gflops=50.0 * d, virtual=v)
        for d in (1, 2, 4) for v in ("False", "True")
    ],
    "error_vs_tolerance.csv": [
        dict(tol=t, val=0.08 + t) for t in (1e-4, 1e-6, 1e-8)
    ],
    "ns_fullscale.csv": [
        dict(solver=s, beta=b, Pr=pr, steps=int(100 / pr), seconds=pr * 10)
        for s in ("mixed", "fast") for b in ("0.0", "0.5")
        for pr in (0.01, 0.1, 1.0)
    ],
    "bench_multigrid.csv": [
        dict(k=k, l=2, coarse=c, solver="ds", backend=be,
             seconds=2.0 ** (k - 12), device_s="" if be == "cpu" else 2.0 ** (k - 13))
        for k in (8, 10, 12) for c in ("jacobi", "dst") for be in ("gpu", "cpu")
    ],
    "mg_workprecision.csv": [
        dict(k=k, solver=s, seconds=2.0 ** (k - 12),
             device_s=2.0 ** (k - 13) if s == "ds" else "")
        for k in (8, 10, 12) for s in ("ds", "cg", "mg_pcg")
    ],
}

EXPECTED = [
    # (figure file, plot fn, CSV it needs)
    ("diffusion_strong_scaling.png", plots.plot_scaling, "diffusion_scaling.csv"),
    ("error_vs_tolerance.png", plots.plot_work_precision, "error_vs_tolerance.csv"),
    ("semi_implicit_vs_explicit.png", plots.plot_timestepping, "ns_fullscale.csv"),
    ("multigrid_bench.png", plots.plot_mg_bench, "bench_multigrid.csv"),
    ("mg_workprecision.png", plots.plot_mg_workprecision, "mg_workprecision.csv"),
]


@pytest.mark.parametrize("fig_name,fn,table", EXPECTED,
                         ids=[e[0] for e in EXPECTED])
def test_figure_regenerates_from_csvs(tmp_path, fig_name, fn, table):
    results = tmp_path / "results"
    results.mkdir()
    _write(results / table, TABLES[table])
    fn(results, tmp_path)
    out = tmp_path / fig_name
    assert out.exists() and out.stat().st_size > 1000, fig_name


def test_timestepping_plot_selects_production_tier(tmp_path, monkeypatch):
    """A full-scale table carrying several solver tiers plots one series
    per beta (the fast tier), not one per tier."""
    results = tmp_path / "results"
    results.mkdir()
    _write(results / "ns_fullscale.csv", TABLES["ns_fullscale.csv"])
    labels = []
    real_loglog = plots.plt.Axes.loglog

    def spy(self, *args, **kw):
        labels.append(kw.get("label"))
        return real_loglog(self, *args, **kw)

    monkeypatch.setattr(plots.plt.Axes, "loglog", spy)
    plots.plot_timestepping(results, tmp_path)
    assert (tmp_path / "semi_implicit_vs_explicit.png").exists()
    # two panels x one series per beta
    assert sorted(labels) == ["β=0.0", "β=0.0", "β=0.5", "β=0.5"]
