"""The ray accounting of bench.py's docstring (lines 46-49), as the
benchmark counts it."""
import pytest

from scenes import load_config, rays_per_iteration
from workload import load_mix


@pytest.mark.parametrize("config,mix,millions", [
    ("cbox", "train", 201.3), ("cbox", "renderD_fwd", 201.3),
    ("cbox", "frame", 58.7)])
def test_rays_per_iteration(config, mix, millions):
    rays = rays_per_iteration(load_config(config), load_mix(mix))
    assert round(rays / 1e6, 1) == millions


def test_box_step_per_pixel():
    # 32 (1 + 6) + 32 * 2 (1 + 6) + 32 * 3 rays a pixel at depth 3
    rays = rays_per_iteration(load_config("cbox"), load_mix("train"),
                              n_pix=1)
    assert rays == 768
