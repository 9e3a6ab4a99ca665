"""The (R,3) wrappers and host-to-device helpers that rfw_tpu's tools and
tests call, against rfw_tpu's on the same seeded numpy inputs:

  * render/disney.py: disney_eval, disney_pdf, disney_sample,
    build_tangent_frame, to_local, to_world: each its component form
    stacked, bit for bit, and against rfw_tpu's at the tolerances
    tests/test_torch_disney.py holds the component forms to (rtol 1e-5,
    atol 1e-6; a sample's lobe flag exactly, its path weight at rtol 2e-4);
  * render/wavefront.py: camera_rays under a threefry key over the pixel
    ids of the 1,024-lane block swizzle, rtol 1e-5, atol 1e-6 (the blade
    angles' sin and cos come from different libraries);
  * render/film.py: frame_to_host, bit for bit;
  * render/atlas.py: atlas_to_device, bit for bit (the uint32 texel pool
    as its int32 bits);
  * render/lights_pack.py: upload_lights, bit for bit, and equal to
    convert.lights_to_device field for field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu.render import disney as jd
from rfw_tpu_torch.render import disney as td
from test_torch_disney import ATOL, MASKS, RTOL, _jax, _torch, make_inputs


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("features", MASKS)
def test_disney_wrappers(inputs, features):
    """Each wrapper is its component form stacked, bit for bit, and
    agrees with rfw_tpu's wrapper as tests/test_torch_disney.py holds the
    component forms: eval and pdf at RTOL/ATOL; a sample's direction at
    RTOL/1e-5, its lobe flag exactly and its path weight f*|cos|/pdf at
    rtol 2e-4 (f and pdf alone sit on the lobe's peak, where an ulp of wi
    moves them by up to ~1e-2)."""
    params, wo, wi, u = inputs
    pj, pt = _jax(params), _torch(params)
    wo_t, wi_t, u_t = (torch.from_numpy(a) for a in (wo, wi, u))
    wo_c, wi_c = td.v3_split(wo_t), td.v3_split(wi_t)

    got = td.disney_eval(pt, wo_t, wi_t, features)
    assert got.shape == (wo.shape[0], 3)
    assert torch.equal(got, td.v3_stack(td.disney_eval_c(pt, wo_c, wi_c, features)))
    _close(got, jd.disney_eval(pj, jnp.asarray(wo), jnp.asarray(wi), features))
    got = td.disney_pdf(pt, wo_t, wi_t, features)
    assert torch.equal(got, td.disney_pdf_c(pt, wo_c, wi_c, features))
    _close(got, jd.disney_pdf(pj, jnp.asarray(wo), jnp.asarray(wi), features))

    gwi, gf, gpdf, gdelta = td.disney_sample(pt, wo_t, u_t, features)
    own = td.disney_sample_c(pt, wo_c, u_t[:, 0], u_t[:, 1], u_t[:, 2], features)
    assert torch.equal(gwi, td.v3_stack(own[0])) and torch.equal(gf, td.v3_stack(own[1]))
    assert torch.equal(gpdf, own[2]) and torch.equal(gdelta, own[3])
    rwi, rf, rpdf, rdelta = (np.asarray(x) for x in jd.disney_sample(
        pj, jnp.asarray(wo), jnp.asarray(u), features))
    assert np.array_equal(gdelta.numpy(), rdelta)
    np.testing.assert_allclose(gwi.numpy(), rwi, rtol=RTOL, atol=1e-5)

    def weight(f, w, pdf):
        return f * np.abs(w[:, 2:3]) / np.maximum(pdf, 1e-9)[:, None]

    np.testing.assert_allclose(weight(gf.numpy(), gwi.numpy(), gpdf.numpy()),
                               weight(rf, rwi, rpdf), rtol=2e-4, atol=ATOL)


def test_frame_wrappers(inputs):
    _, wo, wi, _ = inputs
    t, bt = td.build_tangent_frame(torch.from_numpy(wo))
    rt, rbt = jd.build_tangent_frame(jnp.asarray(wo))
    _close(t, rt)
    _close(bt, rbt)
    n, v = torch.from_numpy(wo), torch.from_numpy(wi)
    _close(td.to_local(t, bt, n, v),
           jd.to_local(rt, rbt, jnp.asarray(wo), jnp.asarray(wi)))
    _close(td.to_world(t, bt, n, v),
           jd.to_world(rt, rbt, jnp.asarray(wo), jnp.asarray(wi)))


@pytest.fixture(scope="module")
def packed():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        return _torch_scene.build("rfw_tpu", seed=2)
    finally:
        mp.undo()


def test_camera_rays(packed):
    from rfw_tpu.render import wavefront as jw
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render import wavefront as tw

    width, height = 64, 32
    view = packed[4].get_view(width, height).as_array()
    view[15] = 0.05  # a lens, so the aperture draws count
    px, py, _ = jw._block_swizzle(width, height, 1024)
    ro, rd = jw.camera_rays(jnp.asarray(view), width, height, jax.random.PRNGKey(5), (px, py))
    tpx, tpy, _ = tw._block_swizzle(width, height, 1024)
    assert np.array_equal(tpx.numpy(), np.asarray(px))
    o, d = tw.camera_rays(torch.from_numpy(view), width, height, threefry.PRNGKey(5), (tpx, tpy))
    assert o.shape == d.shape == (width * height, 3)
    _close(o, ro)
    _close(d, rd)


def test_frame_to_host():
    from rfw_tpu.render.film import frame_to_host as jframe
    from rfw_tpu_torch.render.film import frame_to_host

    frame = np.random.default_rng(4).integers(0, 256, (6, 5, 4), dtype=np.uint8)
    got = frame_to_host(torch.from_numpy(frame))
    ref = jframe(jnp.asarray(frame))
    assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
    assert np.array_equal(got, ref)


def test_atlas_to_device(packed):
    from rfw_tpu.render.atlas import atlas_to_device as jatlas
    from rfw_tpu_torch.render.atlas import atlas_to_device

    atlas = packed[3]
    ref, got = jatlas(atlas), atlas_to_device(atlas, "cpu")
    for f in got._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if r is None:
            assert g is None, f
            continue
        r, g = np.asarray(r), g.numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        assert r.dtype == g.dtype and np.array_equal(r, g), f


def test_upload_lights(packed):
    from rfw_tpu.render.lights_pack import upload_lights as jupload
    from rfw_tpu_torch.convert import lights_to_device
    from rfw_tpu_torch.render.lights_pack import upload_lights

    lights = packed[2]
    ref, got = jupload(lights), upload_lights(lights, "cpu")
    per_field = lights_to_device(lights, "cpu")
    for f in got._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert r.dtype == g.dtype and r.shape == g.shape and np.array_equal(r, g), f
        assert torch.equal(getattr(got, f), getattr(per_field, f)), f
