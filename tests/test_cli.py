"""CLI surface: subcommands run end-to-end and the guards fire.

Mirrors the reference's script entry points (scripts-part1/*.jl,
scripts-part2/part2.jl argument handling); small shapes only — the heavy
paths are covered by the model/solver tests.
"""

import argparse

import jax
import pytest

from fpr_tpu import cli


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """cli.main enables the persistent compile cache; the tests must not."""
    from fpr_tpu.utils import runtime

    monkeypatch.setattr(runtime, "enable_compile_cache", lambda: None)


def test_platform_flag_maps_gpu_to_cuda_and_cpu(monkeypatch):
    p = argparse.ArgumentParser()
    cli._add_common(p)
    assert p.parse_args(["--platform", "gpu"]).platform == "gpu"
    assert p.parse_args(["--platform", "cpu"]).platform == "cpu"
    assert sorted(cli.PLATFORMS) == ["cpu", "gpu"]
    with pytest.raises(SystemExit):
        p.parse_args(["--platform", "xpu"])
    seen = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.append((k, v)))
    cli._force_platform("gpu")
    cli._force_platform(None)
    assert seen == [("jax_platforms", "cuda,cpu")]


def test_mg_ds_dst(capsys):
    cli.main(["mg", "--k", "7", "--l", "5", "--coarse", "dst",
              "--solver", "ds", "--platform", "cpu"])
    out = capsys.readouterr().out
    assert "129^2 -> coarse 33^2 [ds]" in out


def test_mg_sharded_requires_ds():
    with pytest.raises(SystemExit, match="requires --solver ds"):
        cli.main(["mg", "--k", "8", "--devices", "2", "--platform", "cpu"])


def test_mg_sharded_ds(capsys):
    cli.main(["mg", "--k", "11", "--solver", "ds", "--devices", "8",
              "--coarse", "dst", "--l", "9", "--platform", "cpu"])
    out = capsys.readouterr().out
    assert "2049^2 -> coarse 513^2 [ds]" in out


def test_mg_sharded_deep_smoothing(capsys):
    # the sharded ds tier supports --smooths 1..6 (the deep-smoothed
    # production configs shard without extra halo traffic); only
    # out-of-range depths are rejected
    cli.main(["mg", "--k", "11", "--solver", "ds", "--devices", "8",
              "--coarse", "dst", "--l", "9", "--smooths", "5",
              "--platform", "cpu"])
    assert "[ds]" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="1..6"):
        cli.main(["mg", "--k", "11", "--solver", "ds", "--devices", "8",
                  "--smooths", "7", "--platform", "cpu"])


def test_mg_smooths_guards_all_paths():
    # --smooths 0 breaks every solver (the convergence check reads the
    # final post-smooth's norm) and --smooths 7 silently drops the ds tier
    # off the fused stk path — both rejected up front (advisor round 3)
    with pytest.raises(SystemExit, match="must be >= 1"):
        cli.main(["mg", "--k", "7", "--smooths", "0", "--platform", "cpu"])
    with pytest.raises(SystemExit, match="1..6"):
        cli.main(["mg", "--k", "7", "--solver", "ds", "--smooths", "7",
                  "--platform", "cpu"])


def test_ns_no_mg_auto(monkeypatch):
    # --no-mg-auto runs the true default ladder on the fast path
    from fpr_tpu.core.config import MGConfig
    from fpr_tpu.models import navier_stokes as ns

    seen = {}
    real = ns.simulate_fast

    def spy(cfg, **kw):
        seen["cfg"] = ns.fast_mg_default(cfg)
        return real(cfg, **kw)

    monkeypatch.setattr(ns, "simulate_fast", spy)
    cli.main(["ns", "--nx", "257", "--ny", "257", "--Pr", "0.01",
              "--tol", "1e-5", "--ttot", "0.001", "--fast", "--no-mg-auto",
              "--max-steps", "1", "--platform", "cpu"])
    assert seen["cfg"].mg == MGConfig()


def test_ns_fast_guards():
    with pytest.raises(SystemExit, match="f32-only"):
        cli.main(["ns", "--fast", "--f64", "--platform", "cpu"])


def test_ns_fast_policy_flag_keeps_production_ladder(monkeypatch):
    # --policy is irrelevant to the fast tier; passing it must not make
    # cfg.mg look explicitly provided (which would silently skip the
    # DST-257/V(3,3) production ladder in fast_mg_default)
    from fpr_tpu.core.config import MGConfig
    from fpr_tpu.models import navier_stokes as ns

    seen = {}
    real = ns.simulate_fast

    def spy(cfg, **kw):
        seen["mg"] = cfg.mg
        return real(cfg, **kw)

    monkeypatch.setattr(ns, "simulate_fast", spy)
    cli.main(["ns", "--nx", "129", "--ny", "65", "--Pr", "0.01",
              "--tol", "1e-7", "--ttot", "0.001", "--fast", "--policy",
              "pallas", "--max-steps", "1", "--platform", "cpu"])
    assert seen["mg"] == MGConfig()  # default in, fast_mg_default decides


def test_ns_fast_smoke(capsys):
    cli.main(["ns", "--nx", "129", "--ny", "65", "--Pr", "0.01",
              "--tol", "1e-7", "--ttot", "0.001", "--fast",
              "--max-steps", "3", "--platform", "cpu"])
    assert "steps: 3" in capsys.readouterr().out
