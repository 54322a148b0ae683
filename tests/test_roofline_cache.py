"""The roofline's peak table and the compile-cache location."""

import os
import subprocess
import sys

from zpix.utils import cache
from zpix.utils import roofline as rl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_roofline_unknown_device_kind_has_no_share():
    costs = [rl.StageCost("stage", 1e9, 1e9)]
    rep = rl.report(costs, [2.0], "cpu", total_ms=2.0)
    assert "no peak known for 'cpu'" in rep
    assert "%" not in rep
    assert "GB/s" in rep  # achieved rates still print


def test_roofline_known_device_kind_shares():
    peaks = rl.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks.hbm_gbs == 3350.0
    assert round(peaks.int32_tops, 1) == 16.7
    line = rl.StageCost("stage", 3.35e9, 0).line(1.0, peaks)
    assert "(100.0% HBM)" in line


def _cache_dir_in_child(env):
    code = ("import jax; from zpix.utils.cache import enable_compile_cache; "
            "d = enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_cache_dir_env_unset():
    env = {k: v for k, v in os.environ.items() if k != cache.ENV}
    got, jax_dir = _cache_dir_in_child(env)
    assert got == jax_dir == os.path.join(REPO, ".jax_cache")


def test_cache_dir_env_set(tmp_path):
    env = dict(os.environ, **{cache.ENV: str(tmp_path)})
    got, jax_dir = _cache_dir_in_child(env)
    assert got == jax_dir == str(tmp_path)
