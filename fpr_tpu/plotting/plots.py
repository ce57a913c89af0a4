"""Plotting for benchmark CSVs — matplotlib equivalents of the reference's
PGFPlotsX scripts (plotting_scripts/*.jl): scaling bars, operational
intensity, work-precision diagrams, semi-implicit-vs-explicit curves.

    python -m fpr_tpu.plotting.plots --results benchmark-results --figs figs
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def plot_scaling(results: Path, figs: Path):
    path = results / "diffusion_scaling.csv"
    if not path.exists():
        return
    rows = _read(path)
    for mode in ("strong", "weak"):
        sel = [r for r in rows if r["mode"] == mode]
        if not sel:
            continue
        # split the real-hardware points from the virtual-mesh series (the
        # latter validate the sharding path on shared host cores — not
        # scaling measurements; labeled accordingly)
        real = sorted([r for r in sel if r.get("virtual") != "True"],
                      key=lambda r: int(r["devices"]))
        virt = sorted([r for r in sel if r.get("virtual") == "True"],
                      key=lambda r: int(r["devices"]))
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
        for series, tag in ((real, "card"), (virt, "virtual CPU mesh\n(validation)")):
            if not series:
                continue
            devs = [f"{r['devices']} ({tag.splitlines()[0]})" for r in series]
            axes[0].bar(devs, [float(r["throughput_gbs"]) for r in series])
            axes[1].bar(devs, [float(r["performance_gflops"]) for r in series])
        axes[0].set(xlabel="devices", ylabel="T_eff [GB/s]", title=f"{mode} scaling")
        axes[0].set_yscale("log")
        axes[1].set(xlabel="devices", ylabel="GFLOP/s", title=f"{mode} scaling")
        axes[1].set_yscale("log")
        for ax in axes:
            ax.tick_params(axis="x", labelsize=7, rotation=45)
        fig.tight_layout()
        fig.savefig(figs / f"diffusion_{mode}_scaling.png", dpi=150)
        plt.close(fig)


def plot_intensity(results: Path, figs: Path):
    path = results / "bench_diffusion.csv"
    if not path.exists():
        return
    rows = _read(path)
    labels = [f"{r['n']}³/{r['policy']}" for r in rows]
    intens = [float(r["intensity"]) for r in rows if r["intensity"]]
    if not intens:
        return
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.bar(labels[: len(intens)], intens)
    ax.set(ylabel="operational intensity [FLOP/byte]")
    plt.xticks(rotation=45, ha="right")
    fig.tight_layout()
    fig.savefig(figs / "operational_intensity.png", dpi=150)
    plt.close(fig)


def plot_work_precision(results: Path, figs: Path):
    for name, xcol in (("error_vs_tolerance", "tol"), ("error_vs_grid_size", "nx")):
        path = results / f"{name}.csv"
        if not path.exists():
            continue
        rows = _read(path)
        x = [float(r[xcol]) for r in rows]
        v = [float(r["val"]) for r in rows]
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.plot(x, v, "o-")
        if xcol == "tol":
            ax.set_xscale("log")
            ax.invert_xaxis()
        ax.set(xlabel=xcol, ylabel="H(4.5, 4.5, 4.5)")
        fig.tight_layout()
        fig.savefig(figs / f"{name}.png", dpi=150)
        plt.close(fig)


def plot_timestepping(results: Path, figs: Path):
    path = results / "ns_semi_implicit_vs_explicit.csv"
    if not path.exists():
        path = results / "ns_fullscale.csv"
    if not path.exists():
        return
    rows = _read(path)
    # the committed full-scale table carries several solver tiers
    # (mixed / fast / fast_dst* A-B rows / fast_r5 generations); plot the
    # newest production tier present
    for tier in ("fast_r5", "fast"):
        if any(r.get("solver") == tier for r in rows):
            rows = [r for r in rows if r.get("solver") == tier]
            break
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    for beta in sorted({r["beta"] for r in rows}):
        sel = sorted(
            [r for r in rows if r["beta"] == beta], key=lambda r: float(r["Pr"])
        )
        pr = [float(r["Pr"]) for r in sel]
        axes[0].loglog(pr, [int(r["steps"]) for r in sel], "o-", label=f"β={beta}")
        axes[1].loglog(pr, [float(r["seconds"]) for r in sel], "o-", label=f"β={beta}")
    axes[0].set(xlabel="Pr", ylabel="timesteps")
    axes[1].set(xlabel="Pr", ylabel="runtime [s]")
    axes[0].legend()
    fig.tight_layout()
    fig.savefig(figs / "semi_implicit_vs_explicit.png", dpi=150)
    plt.close(fig)


def plot_mg_bench(results: Path, figs: Path):
    path = results / "bench_multigrid.csv"
    if not path.exists():
        return
    rows = _read(path)

    def best_time(r):
        # prefer the amortized device time where the row has one
        d = r.get("device_s", "")
        return float(d) if d else float(r["seconds"])

    fig, ax = plt.subplots(figsize=(6.5, 4))
    # one curve per backend (a cpu 'direct' curve is the crossover
    # comparison, docs/part2.md)
    keys = sorted({(r["coarse"], r["solver"], r.get("backend", ""))
                   for r in rows})
    for coarse, solver, backend in keys:
        sel = [r for r in rows
               if r["coarse"] == coarse and r["solver"] == solver
               and r.get("backend", "") == backend]
        # one (best) point per k
        byk = {}
        for r in sel:
            k = int(r["k"])
            t = best_time(r)
            if k not in byk or t < byk[k]:
                byk[k] = t
        ks = sorted(byk)
        n = [(2 ** k + 1) ** 2 for k in ks]
        t = [byk[k] for k in ks]
        style = "s--" if backend == "cpu" else "o-"
        label = f"{coarse}/{solver}" + (" (cpu)" if backend == "cpu" else "")
        ax.loglog(n, t, style, label=label)
    ax.set(xlabel="unknowns", ylabel="time to tol=1e-6 [s]")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(figs / "multigrid_bench.png", dpi=150)
    plt.close(fig)


def plot_mg_workprecision(results: Path, figs: Path):
    """MG-as-solver vs unpreconditioned CG vs MG-preconditioned CG (the
    BASELINE north-star composition), one curve per solver tier.  Solid:
    wall time; where a row carries an amortized device time a dashed
    companion shows it."""
    path = results / "mg_workprecision.csv"
    if not path.exists():
        return
    rows = _read(path)
    fig, ax = plt.subplots(figsize=(6.5, 4))
    for solver in sorted({r["solver"] for r in rows}):
        sel = sorted(
            [r for r in rows if r["solver"] == solver], key=lambda r: int(r["k"])
        )
        n = [(2 ** int(r["k"]) + 1) ** 2 for r in sel]
        ax.loglog(n, [float(r["seconds"]) for r in sel], "o-", label=solver)
        dev = [(x, float(r["device_s"])) for x, r in zip(n, sel)
               if r.get("device_s", "")]
        if dev:
            ax.loglog(*zip(*dev), "s--", alpha=0.6,
                      label=f"{solver} (device)")
    ax.set(xlabel="unknowns", ylabel="time to tol=1e-6 [s]")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(figs / "mg_workprecision.png", dpi=150)
    plt.close(fig)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="benchmark-results")
    ap.add_argument("--figs", default="figs")
    args = ap.parse_args()
    results, figs = Path(args.results), Path(args.figs)
    figs.mkdir(parents=True, exist_ok=True)
    plot_scaling(results, figs)
    plot_intensity(results, figs)
    plot_work_precision(results, figs)
    plot_timestepping(results, figs)
    plot_mg_bench(results, figs)
    plot_mg_workprecision(results, figs)
    print(f"figures written to {figs}/")


if __name__ == "__main__":
    main()
