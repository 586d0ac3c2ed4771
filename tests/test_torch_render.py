"""The port's camera and splat renderer against the JAX package.

Camera axes and matrices: within 1e-6 (the port computes them in numpy
float32, the JAX package in XLA float32). Frames from the same positions,
species, config and camera pose: pixel for pixel, both methods. The
port's projection runs as separate elementwise ops and reproduces XLA's
rounding on these scenes; a differing pixel would be a wrong key, mask or
palette."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import reference_config
from particle3d_tpu.render import camera as JC
from particle3d_tpu.render.splat import render_frame as jax_render_frame

from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.render import camera as TC
from particle3d_tpu_torch.render.splat import render_frame

POSES = {
    "default": lambda m, c: c,
    "rotated": lambda m, c: m.rotate_camera(c, 20.0, -35.0),
    "pitch_clamped": lambda m, c: m.rotate_camera(c, 500.0, 10.0),
    "moved": lambda m, c: m.move_camera(
        c, 0.4, np.array([0.6, 0.0, -0.8], np.float32)),
    "reference_up": lambda m, c: c.replace(reference_up=True, yaw=30.0),
}


def _pose(mod, name):
    return POSES[name](mod, mod.default_camera(10.0))


@pytest.mark.parametrize("pose", list(POSES))
def test_camera_matches_jax(pose):
    jc, tc = _pose(JC, pose), _pose(TC, pose)
    for a, b in zip(JC.camera_axes(jc), TC.camera_axes(tc)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(TC.view_matrix(tc), np.asarray(JC.view_matrix(jc)),
                               atol=1e-6 * 16)  # |eye| = 16: relative 1e-6
    np.testing.assert_allclose(TC.projection_matrix(tc, 4 / 3),
                               np.asarray(JC.projection_matrix(jc, 4 / 3)),
                               atol=1e-6)
    assert float(tc.pitch) == pytest.approx(float(jc.pitch), abs=1e-6)
    assert TC.view_matrix(tc).dtype == np.float32


def _scene(n, seed, spread=5.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return pos, rng.integers(0, 5, n).astype(np.int32)


@pytest.mark.parametrize("method", ["dilate", "scatter"])
@pytest.mark.parametrize("pose", ["default", "rotated", "reference_up"])
def test_render_frame_matches_jax(method, pose):
    pos, sp = _scene(2000, 0)
    cfg = reference_config()
    want = np.asarray(jax_render_frame(jnp.asarray(pos), jnp.asarray(sp), cfg,
                                       _pose(JC, pose), 320, 240,
                                       method=method))
    got = render_frame(torch.tensor(pos), torch.tensor(sp),
                       from_jax_config(cfg), _pose(TC, pose), 320, 240,
                       method=method)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (240, 320, 3)
    assert (want.sum(-1) > 30).mean() > 0.02  # particles and border visible
    np.testing.assert_array_equal(got.numpy(), want)


def test_render_walls_colours_and_no_border():
    """A recoloured config without the border, and a world of 40 seen from
    its default camera."""
    pos, sp = _scene(3000, 1, spread=20.0)
    cfg = reference_config(world_size=40.0).replace(
        colors=np.linspace(0.1, 0.9, 15, dtype=np.float32).reshape(5, 3))
    for kw in ({"draw_border": False}, {"footprint": 5}):
        want = np.asarray(jax_render_frame(jnp.asarray(pos), jnp.asarray(sp),
                                           cfg, JC.default_camera(40.0), 200,
                                           150, **kw))
        got = render_frame(torch.tensor(pos), torch.tensor(sp),
                           from_jax_config(cfg), TC.default_camera(40.0), 200,
                           150, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["dilate", "scatter"])
def test_depth_test_and_behind_camera(method):
    cfg = from_jax_config(reference_config())
    cam = TC.default_camera(10.0)  # at z=16 looking down -z
    # species 0 (red) in front of species 1 (green) on the view axis, and
    # one particle behind the camera
    pos = torch.tensor([[1.0, 0.0, 2.0], [1.0, 0.0, -2.0], [1.0, 0.0, 100.0]])
    img = render_frame(pos, torch.tensor([0, 1, 2]), cfg, cam, 200, 200,
                       draw_border=False, method=method).numpy()
    lit = img[97:104, 97:104].reshape(-1, 3)
    lit = lit[lit.sum(-1) > 30]
    assert len(lit) > 0 and (lit[:, 0] > 200).all() and (lit[:, 1] < 50).all()
    alone = render_frame(pos[2:], torch.tensor([2]), cfg, cam, 160, 120,
                         draw_border=False, method=method).numpy()
    assert (alone.sum(-1) > 30).sum() == 0


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown render method"):
        render_frame(torch.zeros(1, 3), torch.zeros(1, dtype=torch.int64),
                     from_jax_config(reference_config()),
                     TC.default_camera(10.0), method="raytrace")
