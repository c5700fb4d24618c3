"""Shared CLI plumbing for experiment drivers.

Mirrors the reference's argparse run/plot subcommand pattern (e.g.
examples/gaussian/main.py:223-264) with one safety change: optimization
step schedules are a named registry instead of ``eval``'d lambda strings
(reference gaussian/main.py:151-152,240 evals user input).
"""

from __future__ import annotations

import argparse

from ..utils.cache import enable_compilation_cache
from . import plotting, results


def step_sched(spec: str):
    """Named step schedules: 'inv' -> 1/(1+i), 'invsqrt' -> 1/sqrt(1+i),
    'const:<v>' -> v, 'inv:<a>' -> a/(1+i)."""
    if spec == "inv":
        return lambda i: 1.0 / (1.0 + i)
    if spec == "invsqrt":
        return lambda i: 1.0 / (1.0 + i) ** 0.5
    if spec.startswith("const:"):
        v = float(spec.split(":", 1)[1])
        return lambda i: v
    if spec.startswith("inv:"):
        a = float(spec.split(":", 1)[1])
        return lambda i: a / (1.0 + i)
    raise ValueError(f"unknown step schedule {spec!r} "
                     "(use inv | invsqrt | const:<v> | inv:<a>)")


def plot_command(arguments):
    """Generic plot subcommand (reference gaussian/main.py:15-27)."""
    to_match = dict(vars(arguments))
    for nm in (arguments.summarize or []):
        to_match.pop(nm, None)
    if arguments.plot_legend:
        to_match.pop(arguments.plot_legend, None)
    resdf = results.load_matching(to_match)
    if resdf is None:
        print("No matching results to plot, skipping")
        return
    out = plotting.plot(arguments, resdf)
    print(f"wrote {out}")


class _SharedArgs:
    """Proxy that registers experiment args on every subparser, so both
    ``run --alg X`` and ``plot ... --alg X`` accept them."""

    def __init__(self, parser, subs):
        self._parser = parser
        self._subs = subs

    def add_argument(self, *a, **k):
        for s in self._subs:
            s.add_argument(*a, **k)

    def parse_args(self, argv=None):
        # every driver parses its arguments once, before it compiles
        enable_compilation_cache()
        return self._parser.parse_args(argv)

    def error(self, msg):
        self._parser.error(msg)


def make_parser(description: str):
    parser = argparse.ArgumentParser(description=description)
    sub = parser.add_subparsers(help="sub-command help")
    run_p = sub.add_parser("run", help="Runs the main computational code")
    plot_p = sub.add_parser("plot", help="Plots the results")
    plot_p.set_defaults(func=plot_command)

    shared = _SharedArgs(parser, [run_p, plot_p])
    shared.add_argument("--trial", type=int, default=0,
                        help="Trial number (seeds PRNG for replicability)")
    shared.add_argument("--results_folder", type=str, default="results/")
    shared.add_argument("--verbosity", type=str, default="error",
                        choices=["error", "warning", "critical", "info", "debug"])

    plot_p.add_argument("plot_x", type=str)
    plot_p.add_argument("plot_y", type=str)
    plot_p.add_argument("--plot_title", type=str)
    plot_p.add_argument("--plot_x_label", type=str)
    plot_p.add_argument("--plot_y_label", type=str)
    plot_p.add_argument("--plot_x_type", choices=["linear", "log"], default="log")
    plot_p.add_argument("--plot_y_type", choices=["linear", "log"], default="log")
    plot_p.add_argument("--plot_legend", type=str)
    plot_p.add_argument("--plot_type", choices=["line", "scatter"], default="scatter")
    plot_p.add_argument("--plot_out", type=str, help="Output image path")
    plot_p.add_argument("--summarize", type=str, nargs="*")
    plot_p.add_argument("--groupby", type=str)
    return shared, run_p, plot_p


def coreset_size_grid(size_max: int, num_sizes: int, spacing: str, with_zero=True):
    import numpy as np
    if spacing == "log":
        Ms = np.unique(np.logspace(0.0, np.log10(size_max), num_sizes, dtype=np.int32))
    else:
        Ms = np.unique(np.linspace(1, size_max, num_sizes, dtype=np.int32))
    if with_zero and Ms[0] != 0:
        Ms = np.hstack((0, Ms))
    return Ms
