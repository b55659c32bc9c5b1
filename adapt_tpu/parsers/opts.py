"""CLI option parsing (reference parsers/opts.py:15-71).

Plain argparse with an optional `--config <file>` layer (one `key = value`
per line, '#' comments) replacing the configargparse dependency.
"""
from __future__ import annotations

import argparse
import shlex


def _apply_config_file(parser: argparse.ArgumentParser, argv):
    """Prepend options from a config file so CLI flags take precedence.

    Boolean (store_true) flags accept the configargparse forms
    'debug = true' / 'debug = false' — the bare '--debug true' expansion
    would crash argparse with 'unrecognized arguments'."""
    flags = {a.dest for a in parser._actions
             if isinstance(a, argparse._StoreTrueAction)}
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    known, _ = pre.parse_known_args(argv)
    if not known.config:
        return argv
    file_args = []
    with open(known.config) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                k, v = (t.strip() for t in line.split("=", 1))
                if k.replace("-", "_") in flags:
                    if v.lower() in ("true", "1", "yes", "on"):
                        file_args.append(f"--{k}")
                    elif v.lower() not in ("false", "0", "no", "off"):
                        raise SystemExit(
                            f"config: boolean flag '{k}' got '{v}' "
                            "(expected true/false)")
                else:
                    file_args += [f"--{k}"] + shlex.split(v)
            else:
                file_args.append(f"--{line}")
    return file_args + list(argv)


def get_options(argv=None):
    """Render CLI flags; mirrors the reference surface (opts.py:17-44)."""
    parser = argparse.ArgumentParser("adapt_tpu renderer")
    parser.add_argument("--config", type=str, default=None,
                        help="config file with 'key = value' lines")
    parser.add_argument("--iter_num", type=int, default=-1,
                        help="number of progressive iterations "
                             "(-1: use scene sample_count)")
    parser.add_argument("--normalize", type=float, default=0.0,
                        help="quantile normalization (0 = off)")
    parser.add_argument("--output_freq", type=int, default=0,
                        help="dump an intermediate image every N iters")
    parser.add_argument("--input_path", type=str, default="./scenes/")
    parser.add_argument("--output_path", type=str, default="./outputs/")
    parser.add_argument("--img_name", type=str, default="pbr")
    parser.add_argument("--img_ext", type=str, default="png",
                        choices=["png", "jpg", "bmp", "npy"])
    parser.add_argument("--scene", type=str, default="cbox")
    parser.add_argument("--name", type=str, default="cbox.xml")
    parser.add_argument("--arch", type=str, default="gpu",
                        choices=["gpu", "cpu"],
                        help="jax platform to run on; gpu pins CUDA and "
                             "fails where there is no card")
    parser.add_argument("--type", type=str, default="pt",
                        choices=["pt", "vpt", "bdpt", "ao", "direct"])
    parser.add_argument("--multichip", type=int, default=0, metavar="N",
                        help="SPMD render over an ('spp','px') device mesh: "
                             "N devices (-1 = all visible). pt/vpt/bdpt "
                             "only. 0 = single-chip (default)")
    parser.add_argument("--save_iter", type=int, default=0,
                        help="checkpoint save cadence (0 = only on exit)")
    parser.add_argument("-p", "--profile", action="store_true",
                        help="dump a jax profiler trace")
    parser.add_argument("--no_gui", action="store_true", default=True,
                        help="headless (always true here; kept for "
                             "reference CLI compat — see --serve)")
    parser.add_argument("--serve", type=int, default=-1, metavar="PORT",
                        help="live incremental preview over HTTP on PORT "
                             "(0 = pick a free port); the headless "
                             "replacement for the reference's GUI window")
    parser.add_argument("-d", "--debug", action="store_true",
                        help="enable jax nan/inf checking")
    parser.add_argument("-a", "--analyze", action="store_true",
                        help="run transient time-domain analysis on export")
    parser.add_argument("-l", "--load", action="store_true",
                        help="resume from checkpoint")
    parser.add_argument("--no_cache", action="store_true",
                        help="disable the persistent jit compile cache")
    parser.add_argument("--no_save_fig", action="store_true")
    parser.add_argument("--no_watermark", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--true_unwarped", action="store_true",
                        help="TRUE camera-unwarped transient binning "
                             "(subtract the camera first-leg time). The "
                             "reference declares decomposition="
                             "transient_lit but coerces it to warped "
                             "(bdpt.py:42-46); this opt-in implements it")
    parser.add_argument("--width", type=int, default=0,
                        help="override film width (focal rescaled)")
    parser.add_argument("--height", type=int, default=0)
    parser.add_argument("--max_bounce", type=int, default=0,
                        help="override scene max_bounce")
    parser.add_argument("--batch_spp", type=int, default=1,
                        help="samples fused per device dispatch")
    argv = _apply_config_file(parser, argv if argv is not None else
                              __import__("sys").argv[1:])
    return parser.parse_args(argv)


def get_tdom_options(argv=None):
    """Transient-analysis tool flags (reference opts.py:46-71)."""
    parser = argparse.ArgumentParser("adapt_tpu transient analysis")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--input_path", type=str, required=True,
                        help="directory of exported transient frames (.npy)")
    parser.add_argument("--window_mode", type=str, default="diag",
                        choices=["diag", "whole"])
    parser.add_argument("--window_size", type=int, default=5)
    parser.add_argument("--sol", type=float, default=1.0,
                        help="speed of light (scene units per time unit)")
    parser.add_argument("--interval", type=float, default=1.0)
    parser.add_argument("--start_time", type=float, default=0.0)
    parser.add_argument("--save_path", type=str, default="")
    parser.add_argument("--viz", action="store_true")
    argv = _apply_config_file(parser, argv if argv is not None else
                              __import__("sys").argv[1:])
    return parser.parse_args(argv)
