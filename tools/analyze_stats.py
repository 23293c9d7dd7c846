#!/usr/bin/env python
"""Recorded-run analysis CLI (the stat_analysis.ipynb replacement).

Loads one or more stats directories in the reference .npy schema
({stem}_{dts,tracking_errors,ee_positions,ee_ref_positions,
joint_positions,solve_times}.npy — gato_controller.py:288-293) and prints
the comparison table of BASELINE.md (mean/p50/p95 tracking error, solve
times, control period); optionally writes overlay plots.

Works on both the reference's recorded runs (/root/reference/stats/*) and
this framework's RunRecorder output — apples to apples.

Usage:
  python tools/analyze_stats.py DIR [DIR ...] [--plot out.png]
"""
import argparse
import glob
import os
import sys

import numpy as np


def find_runs(d):
    runs = {}
    for pat in ("*_tracking_errors.npy", "*/*_tracking_errors.npy"):
        for f in glob.glob(os.path.join(d, pat)):
            stem = f[: -len("_tracking_errors.npy")]
            runs[stem] = True
    return sorted(runs)


def load(stem):
    out = {}
    for name in (
        "dts", "tracking_errors", "ee_positions", "ee_ref_positions",
        "joint_positions", "solve_times",
        # estimator-accuracy sidecars (RunRecorder.EXTRA_ARRAYS)
        "f_est", "f_true",
    ):
        path = f"{stem}_{name}.npy"
        out[name] = np.load(path) if os.path.exists(path) else None
    return out


def estimator_stats(f_est, f_true, walk_period=200, settle_frac=0.25):
    """Estimator accuracy vs the true wrench (force components).

    Returns a dict with the steady-state force-estimation error and the
    per-walk convergence lag: the runtime walks the true disturbance
    every ``walk_period`` reference steps (gato_controller.py:236-239);
    after each walk the consensus estimator needs some ticks to re-lock.
    Lag = first tick within the window where the error reaches within
    ``settle_frac`` of the way down from its post-walk peak toward the
    window's settled level (median of the window's second half).
    """
    err = np.linalg.norm(f_est[:, :3] - f_true[:, :3], axis=1)
    out = {
        "fe_err_mean": float(err.mean()),
        "fe_err_p50": float(np.percentile(err, 50)),
        "fe_err_p95": float(np.percentile(err, 95)),
    }
    lags = []
    for start in range(0, len(err) - walk_period + 1, walk_period):
        w = err[start:start + walk_period]
        settled = np.percentile(w[walk_period // 2:], 50)
        peak = w[:10].max()
        if peak <= settled:  # walk didn't move the error; no lag
            lags.append(0)
            continue
        thresh = settled + settle_frac * (peak - settled)
        below = np.nonzero(w <= thresh)[0]
        lags.append(int(below[0]) if len(below) else walk_period)
    if lags:
        out["fe_lag_p50"] = float(np.percentile(lags, 50))
        out["fe_lag_p95"] = float(np.percentile(lags, 95))
        out["fe_windows"] = len(lags)
    return out


def describe(stem, data):
    te = data["tracking_errors"]
    st = data["solve_times"]
    dts = data["dts"]
    row = {
        "run": stem,
        "ticks": len(te) if te is not None else 0,
    }
    if te is not None and len(te):
        row.update(
            te_mean=te.mean(),
            te_p50=np.percentile(te, 50),
            te_p95=np.percentile(te, 95),
        )
    if st is not None and len(st):
        row.update(
            solve_us_mean=st.mean(),
            solve_us_p50=np.percentile(st, 50),
            solve_us_p95=np.percentile(st, 95),
            solve_us_max=st.max(),
        )
    if dts is not None and len(dts):
        row["dt_ms_mean"] = 1e3 * dts.mean()
    if data.get("f_est") is not None and data.get("f_true") is not None:
        row.update(estimator_stats(data["f_est"], data["f_true"]))
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--plot", default=None, help="write overlay plot PNG")
    ap.add_argument("--plot3d", default=None,
                    help="write 3D EE path vs reference grid PNG "
                         "(stat_analysis.ipynb cell 2 equivalent)")
    ap.add_argument("--plot-est", default=None,
                    help="write estimated-vs-true wrench PNG (runs with "
                         "f_est/f_true sidecars)")
    args = ap.parse_args()

    rows = []
    for d in args.dirs:
        stems = find_runs(d)
        if not stems:
            print(f"(no runs found in {d})", file=sys.stderr)
        for stem in stems:
            rows.append((stem, load(stem)))

    cols = [
        ("run", "{:<40}"), ("ticks", "{:>6}"),
        ("te_mean", "{:>8.4f}"), ("te_p50", "{:>8.4f}"),
        ("te_p95", "{:>8.4f}"), ("solve_us_mean", "{:>12.0f}"),
        ("solve_us_p95", "{:>12.0f}"), ("dt_ms_mean", "{:>8.2f}"),
        ("fe_err_p50", "{:>10.2f}"), ("fe_lag_p50", "{:>10.0f}"),
    ]
    print(" ".join(name for name, _ in cols))
    for stem, data in rows:
        row = describe(stem, data)
        cells = []
        for name, fmt in cols:
            v = row.get(name)
            cells.append(fmt.format(v) if v is not None else " " * 8)
        print(" ".join(cells))

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, figsize=(11, 7), sharex=False)
        for stem, data in rows:
            label = os.path.relpath(stem)
            te = data["tracking_errors"]
            if te is not None:
                axes[0].plot(te, label=f"{label} (mean {te.mean():.3f})",
                             lw=0.8)
            st = data["solve_times"]
            if st is not None:
                axes[1].plot(st / 1e3, label=label, lw=0.8)
        axes[0].set_ylabel("tracking error [m]")
        axes[0].legend(fontsize=7)
        axes[1].set_ylabel("solve time [ms]")
        axes[1].set_xlabel("tick")
        axes[1].legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")

    if args.plot_est:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        est_runs = [
            (stem, d) for stem, d in rows
            if d.get("f_est") is not None and d.get("f_true") is not None
        ]
        if not est_runs:
            print("(no runs with f_est/f_true for --plot-est)",
                  file=sys.stderr)
        else:
            fig, axes = plt.subplots(
                4, 1, figsize=(11, 9), sharex=True,
            )
            colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
            for ri, (stem, d) in enumerate(est_runs):
                label = os.path.relpath(stem)
                fe, ft = d["f_est"], d["f_true"]
                for a in range(3):
                    axes[a].plot(fe[:, a], lw=0.7,
                                 color=colors[ri % len(colors)],
                                 label=f"{label} est" if a == 0 else None)
                    axes[a].plot(ft[:, a], lw=1.0, ls="--",
                                 color=colors[ri % len(colors)],
                                 alpha=0.6,
                                 label=f"{label} true" if a == 0 else None)
                    axes[a].set_ylabel(f"F{'xyz'[a]} [N]")
                err = np.linalg.norm(fe[:, :3] - ft[:, :3], axis=1)
                axes[3].plot(err, lw=0.7,
                             color=colors[ri % len(colors)],
                             label=f"{label} (p50 {np.median(err):.1f} N)")
            axes[3].set_ylabel("|f_est - f_true| [N]")
            axes[3].set_xlabel("tick")
            axes[0].legend(fontsize=6)
            axes[3].legend(fontsize=6)
            fig.tight_layout()
            fig.savefig(args.plot_est, dpi=120)
            print(f"wrote {args.plot_est}")

    if args.plot3d:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        runs3d = [
            (stem, d) for stem, d in rows
            if d["ee_positions"] is not None
            and d["ee_ref_positions"] is not None
        ]
        if not runs3d:
            print("(no runs with ee paths for --plot3d)", file=sys.stderr)
            return
        ncols = min(4, len(runs3d))
        nrows = (len(runs3d) + ncols - 1) // ncols
        fig = plt.figure(figsize=(4.2 * ncols, 3.8 * nrows))
        for i, (stem, d) in enumerate(runs3d):
            ax = fig.add_subplot(nrows, ncols, i + 1, projection="3d")
            ee = d["ee_positions"]
            ref = d["ee_ref_positions"]
            ax.plot(*ref.T, lw=0.8, color="0.55", label="reference")
            ax.plot(*ee.T, lw=0.7, label="ee path")
            ax.set_title(os.path.relpath(stem), fontsize=7)
            ax.tick_params(labelsize=6)
            if i == 0:
                ax.legend(fontsize=6)
        fig.tight_layout()
        fig.savefig(args.plot3d, dpi=120)
        print(f"wrote {args.plot3d}")


if __name__ == "__main__":
    main()
