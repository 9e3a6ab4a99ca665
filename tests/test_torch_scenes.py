"""The port's procedural scenes (`rfw_tpu_torch/scenes.py`): the flagship-
scale scene has the counts `PERF.md` states for it, at full size, and a
seed rebuilds every array bit for bit."""

from dataclasses import asdict

import numpy as np
import pytest

from rfw_tpu_torch.scenes import build_heavy_scene, build_scene


def _arrays(built):
    scene, mats, lights, atlas, camera = built[:5]
    return {**{f"scene.{k}": v for k, v in scene._asdict().items()},
            **{f"mats.{k}": v for k, v in asdict(mats).items()},
            **{f"lights.{k}": v for k, v in lights._asdict().items()},
            **{f"atlas.{k}": v for k, v in atlas._asdict().items() if v is not None},
            "view": camera.get_view(64, 48).as_array()}


@pytest.fixture(scope="module")
def flagship():
    return build_scene(7), build_scene(7)


def test_flagship_counts(flagship):
    scene = flagship[0][0]
    assert scene.tri_v0.shape[0] == 122_880
    assert scene.inst_matrix.shape[0] == 512
    assert int((scene.inst_mesh >= 0).sum()) == 4 * 64 + 2  # spheres, floor, lamp
    assert int(flagship[0][2].n_area[0]) == 2


def test_flagship_is_reproducible(flagship):
    a, b = (_arrays(x) for x in flagship)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_heavy_scene_is_reproducible():
    a, b = (_arrays(build_heavy_scene(8, 300)) for _ in range(2))
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert int((build_heavy_scene(8, 300)[0].inst_mesh >= 0).sum()) == 300 + 2
