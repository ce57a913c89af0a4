"""chip_smoke.py's phases at tiny sizes on the CPU (the script itself
refuses to run without a GPU), and the same phases at moderate sizes on a
card (``gpu`` marker)."""

import subprocess
import sys

import pytest

import chip_smoke


def test_phase_eft():
    chip_smoke.phase_eft(20_000, seed=0)


def test_phase_diffusion():
    chip_smoke.phase_diffusion(24, steps=2, iter_max=60, tol=1e-6, seed=0)


def test_phase_mg():
    chip_smoke.phase_mg(10, tol=1e-6, seed=0)


@pytest.mark.parametrize("beta,steps", [(0.0, 6), (0.5, 3)])
def test_phase_ns(beta, steps):
    chip_smoke.phase_ns(257, 65, beta, steps, Pr=0.01, tol=1e-7, seed=0)


def test_phase_dist_diffusion():
    chip_smoke.phase_dist_diffusion(16, 4, iter_max=300, tol=1e-6)


def test_phase_dist_mg():
    chip_smoke.phase_dist_mg(9, 4, tol=1e-6, seed=0, coarse=17,
                             replicate_below=65)


def test_phase_dist_ns():
    chip_smoke.phase_dist_ns(129, 65, 4, steps=4, Pr=0.01, tol=1e-7, seed=0,
                             replicate_below=33)


def test_check_raises_over_limit():
    with pytest.raises(AssertionError, match="exceeds"):
        chip_smoke._check("x", 2.0, 1.0, "test")


def test_script_refuses_cpu():
    """No GPU: non-zero exit and no closing JSON line."""
    p = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


@pytest.mark.gpu
def test_phases_on_card(gpu):
    chip_smoke.phase_eft(1_000_000, seed=1)
    chip_smoke.phase_diffusion(128, steps=2, iter_max=300, tol=1e-6, seed=1)
    chip_smoke.phase_mg(11, tol=1e-6, seed=1)
    chip_smoke.phase_ns(513, 129, 0.0, 10, Pr=0.01, tol=1e-7, seed=1)
    chip_smoke.phase_ns(513, 129, 0.5, 3, Pr=0.01, tol=1e-7, seed=1)
