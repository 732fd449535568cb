"""The parameters' draw: every seed sets the same distance between the
start and the target, so that the training check's loss is of one size
from seed to seed."""
import numpy as np
import pytest

from scenes import draw_offsets, load_config, scene_arrays


@pytest.mark.parametrize("seed", [0, 1262759939, 2 ** 31 + 11])
def test_every_target_lies_its_distance_from_the_start(seed):
    config = load_config("cbox")
    start, target = draw_offsets(config, scene_arrays(config), seed)
    for p in config["params"]:
        s, t = start[p["name"]], target[p["name"]]
        assert np.all(np.abs(s) <= p["start"])
        np.testing.assert_allclose(np.abs(t - s), p["target"], rtol=1e-6)


def test_the_seed_picks_the_sides():
    config = load_config("cbox")
    arrays = scene_arrays(config)
    a = draw_offsets(config, arrays, 1)
    b = draw_offsets(config, arrays, 1)
    c = draw_offsets(config, arrays, 2)
    assert all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
    assert not np.array_equal(np.sign(a[1]["dv"] - a[0]["dv"]),
                              np.sign(c[1]["dv"] - c[0]["dv"]))
