"""The renderer's CUDA path (``render/splat._render_kernel`` and
``csrc/splat.cu``) on the CPU: which frames take it, the host blocks its
kernels read against what the plain torch version computes, and the
kernels' source compiled with g++ against ``tests/_cuda_emulation`` and
held to the plain version pixel for pixel.

The emulation runs the kernels' logic with the host's IEEE float
arithmetic, which is what the rounded intrinsics give on the card, so a
frame must equal the plain version's bit for bit; ``chip_smoke.py`` phase
18 holds the kernels to the plain version on the card. Skipped where no
g++ with C++20's ``<barrier>`` is installed.
"""

import numpy as np
import pytest
import torch

from _cuda_emulated import Emulated, build
from particle3d_tpu_torch.config import reference_config
from particle3d_tpu_torch.ops import kernel_launches, reset_kernel_launches
from particle3d_tpu_torch.render import camera as C
from particle3d_tpu_torch.render import splat as S
from particle3d_tpu_torch.utils import profiling as prof

SEED_SIG = "p" * 5 + "i" * 6 + "p"
DILATE_SIG = "p" * 4 + "i" * 3 + "p"


def _scene(n, seed, spread):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return torch.tensor(pos), torch.tensor(rng.integers(0, 5, n))


def test_kernel_path_is_chosen_by_device_method_and_footprint():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert S._kernel_path(cuda, "dilate", 7)
    assert S._kernel_path(cuda, "dilate", 1)
    assert not S._kernel_path(cuda, "scatter", 7)
    assert not S._kernel_path(cuda, "dilate", 9)
    assert not S._kernel_path(cuda, "dilate", 0)
    assert not S._kernel_path(cpu, "dilate", 7)


def test_cpu_frames_take_the_plain_path_and_launch_nothing(monkeypatch):
    """CPU tensors, "scatter" and footprint 9: one ``render.frame`` span
    each, path "plain", and no splat launch. (The spans are taken from
    ``span`` itself: a profiler session, which records them, takes ~2 s to
    start; ``tests/test_torch_tracing.py`` covers the recording.)"""
    pos, sp = _scene(300, 0, 5.0)
    cfg = reference_config()
    cam = C.default_camera(10.0)
    frames = []

    def record(name, **attrs):
        frames.append((name, attrs))
        return prof.span(name, **attrs)

    monkeypatch.setattr(S, "span", record)
    reset_kernel_launches()
    for kw in ({}, {"method": "scatter"}, {"footprint": 9}):
        S.render_frame(pos, sp, cfg, cam, 64, 48, **kw)
    assert frames == [("render.frame", {"path": "plain"})] * 3
    launches = kernel_launches()
    assert launches["splat_seed"] == launches["splat_dilate"] == 0
    S.KERNEL_LAUNCHES["splat_seed"] = 3
    reset_kernel_launches()
    assert kernel_launches()["splat_seed"] == 0


CAMERAS = {
    "default": C.default_camera(10.0),
    "rotated": C.rotate_camera(C.default_camera(40.0), 20.0, -35.0),
    "reference_up_fov60": C.default_camera(10.0).replace(
        reference_up=True, yaw=30.0, fov_deg=60.0),
}


@pytest.mark.parametrize("cam", list(CAMERAS))
@pytest.mark.parametrize("size", [(640, 480), (200, 150)])
def test_seed_params_equal_the_plain_versions_uploads(cam, size, monkeypatch):
    """The matrices the plain version uploads and the radius' numerator it
    fills, captured as it renders, against the kernels' float32 block."""
    uploads, fills = [], []
    as_tensor, full = torch.as_tensor, torch.full

    def record_upload(x, *a, **kw):
        if isinstance(x, np.ndarray) and x.shape == (4, 4):
            uploads.append(x.copy())
        return as_tensor(x, *a, **kw)

    def record_fill(shape, value, *a, **kw):
        if tuple(shape) == () and isinstance(value, float):
            fills.append(value)
        return full(shape, value, *a, **kw)

    monkeypatch.setattr(torch, "as_tensor", record_upload)
    monkeypatch.setattr(torch, "full", record_fill)
    w, h = size
    camera = CAMERAS[cam]
    pos, sp = _scene(50, 1, 5.0)
    S.render_frame(pos, sp, reference_config(), camera, w, h, footprint=5)
    params = S._seed_params(camera, w, h, 5)
    assert params.dtype == np.float32 and params.shape == (34,)
    vm, pm = uploads
    np.testing.assert_array_equal(params[:16], vm.ravel())
    np.testing.assert_array_equal(params[16:32], pm.ravel())
    assert fills == [float(params[32])]
    assert params[33] == np.float32(2.5)


def test_seed_params_are_cached_per_pose():
    """The cache gives the block ``_seed_params`` computes, once per pose
    and frame, and a pose that differs in any field (or its dtype) misses."""
    cams = [*CAMERAS.values(), CAMERAS["default"].replace(near=0.01),
            CAMERAS["default"].replace(pitch=np.float32(0.0)),
            C.move_camera(CAMERAS["default"], 0.01, [1.0, 0.0, 0.0])]
    got = [S._cached_seed_params(c, 640, 480, 7) for c in cams]
    for c, params in zip(cams, got):
        np.testing.assert_array_equal(params, S._seed_params(c, 640, 480, 7))
        assert S._cached_seed_params(c, 640, 480, 7) is params
    assert len({id(p) for p in got}) == len(cams)
    assert S._cached_seed_params(cams[0], 320, 240, 7) is not got[0]


def _dilate_probe(footprint, radii):
    """[len(radii), 2h + 1, 2h + 1]: whether ``_dilate`` lets one key of
    each radius (1/16 px) cover the pixel at each offset from its seed."""
    half = footprint // 2
    k = 2 * half + 1
    seeds = torch.full((len(radii) * k, k), S._EMPTY, dtype=torch.int32)
    keys = torch.tensor([(1 << 16) | (q << 8) | 7 for q in radii],
                        dtype=torch.int32)
    seeds[torch.arange(len(radii)) * k + half, half] = keys
    out = S._dilate(seeds, len(radii) * k, k, footprint)
    return (out.reshape(len(radii), k, k) == keys[:, None, None]).numpy()


@pytest.mark.parametrize("footprint", [3, 5, 7])
def test_thresholds_are_what_dilate_judges(footprint):
    """Each offset's threshold is the least radius whose key ``_dilate``
    lets cover it; the kernels' 7x7 table holds it at the centre and 256
    (never covered) outside the footprint's window."""
    covered = _dilate_probe(footprint, range(256))
    least = np.where(covered.any(0), covered.argmax(0), 256)
    thr = S._dilate_thresholds(footprint)
    np.testing.assert_array_equal(thr, least)
    assert (covered == (np.arange(256)[:, None, None] >= thr)).all()
    table = S._kernel_thresholds(footprint)
    half, mid = footprint // 2, S._KERNEL_HALF
    assert table.shape == (7, 7) and table.dtype == np.int32
    np.testing.assert_array_equal(
        table[mid - half:mid + half + 1, mid - half:mid + half + 1], thr)
    outside = np.ones((7, 7), bool)
    outside[mid - half:mid + half + 1, mid - half:mid + half + 1] = False
    assert (table[outside] == 256).all()


def test_thresholds_skip_what_dilate_skips():
    """Offsets past radius 255 / 16 px (footprint 25): 256 in the table
    exactly where ``_dilate`` skips them, even for the widest key."""
    thr = S._dilate_thresholds(25)
    covered = _dilate_probe(25, [255])[0]
    assert (thr == 256).sum() > 0
    np.testing.assert_array_equal(thr == 256, ~covered)


def test_palette_bytes_are_what_decode_writes():
    """Every colour id, and the empty key, through ``_decode`` against the
    kernels' palette, with colours outside [0, 1] among them."""
    rng = np.random.default_rng(2)
    colors = rng.uniform(-0.3, 1.3, (5, 3)).astype(np.float32)
    colors[0] = [0.0, 1.0, 0.5004]
    cfg = reference_config().replace(colors=colors)
    ids = torch.arange(256, dtype=torch.int32)
    keys = torch.cat([(ids + (3 << 16) + (17 << 8)),
                      torch.tensor([S._EMPTY], dtype=torch.int32)])
    want = S._decode(keys[None], cfg)[0].numpy()
    rgb = S._palette_rgb(np.asarray(cfg.colors, np.float32).tobytes())
    assert rgb.shape == (256, 4) and rgb.dtype == np.uint8
    np.testing.assert_array_equal(rgb[:, :3], want[:256])
    np.testing.assert_array_equal(rgb[S.BACKGROUND_ID, :3], want[256])
    assert (rgb[:, 3] == 0).all()
    assert S._palette_rgb(colors.tobytes()) is rgb


@pytest.mark.parametrize("world,samples", [(10.0, 128), (40.0, 128),
                                           (np.float32(12.3), 7)])
def test_border_points_are_the_plain_versions(world, samples):
    cpu = torch.device("cpu")
    got = S._border_points(float(np.asarray(world)), samples, cpu)
    want = S._box_edge_points(world, samples, cpu)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert S._border_points(float(np.asarray(world)), samples, cpu) is got


# --------------------------------------------------------------------- #
# the kernels' source, emulated on the CPU
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def splat_lib(tmp_path_factory):
    paths = build(tmp_path_factory.mktemp("splat_emulated"), {"splat": 3})
    if paths is None:
        pytest.skip("no g++ with C++20's <barrier> for the CPU emulation")
    emu = Emulated()
    yield lambda fn, sig, args, outs: emu.call(paths["splat"], fn, sig, args,
                                                outs)
    emu.close()


def _emulated_frame(lib, pos, sp, cfg, cam, width, height, footprint=7,
                    draw_border=True, border_samples=16, pos_stride=3):
    """The kernels' frame; with ``pos_stride`` > 3 the positions are read
    as columns 3-5 of rows that many floats wide, as from a view."""
    border = (S._border_points(float(np.asarray(cfg.world_size)),
                               border_samples, torch.device("cpu")).numpy()
              if draw_border else np.zeros((0, 3), np.float32))
    seeds = np.full(height * width, S._EMPTY, np.int32)
    spc = sp.numpy()
    rows = pos.numpy()
    if pos_stride > 3:
        wide = np.full((len(rows), pos_stride), np.nan, np.float32)
        wide[:, 3:6] = rows
        rows = wide.ravel()[3:]  # contiguous, from row 0's column 3
    err, (seeds,) = lib("p3t_splat_seed", SEED_SIG,
                        [rows, spc, border,
                         S._seed_params(cam, width, height, footprint), seeds,
                         pos.shape[0], border.shape[0], width, height,
                         spc.itemsize, pos_stride, None], (4,))
    assert err == 0
    img = np.zeros((height, width, 3), np.uint8)
    err, (img,) = lib("p3t_splat_dilate", DILATE_SIG,
                      [seeds, S._kernel_thresholds(footprint),
                       _palette(cfg), img, width, height,
                       footprint // 2, None], (3,))
    assert err == 0
    return img


def _palette(cfg):
    return S._palette_rgb(np.asarray(cfg.colors, np.float32).tobytes())


def _plain(pos, sp, cfg, cam, width, height, footprint=7, draw_border=True):
    return S._render_plain(pos, sp, cfg, cam, width, height,
                           footprint=footprint, draw_border=draw_border,
                           border_samples=16, method="dilate").numpy()


W, H = 40, 26  # a ragged last tile in x and in y
CLOSE = C.Camera(position=np.float32([0.0, 0.0, 0.0]))  # looks down -z
TURNED = C.rotate_camera(C.Camera(position=np.float32([2.0, -1.0, 3.0])),
                         -25.0, 40.0)


def _gallery(qs):
    """Points seen by CLOSE on an 8 px grid, each at the depth that gives
    its splat the radius in ``qs`` (1/16 px), centred a fraction of a
    pixel off their grid point: discs that never overlap, one a radius."""
    params = S._seed_params(CLOSE, W, H, 7)
    pm, r_num = params[16:32].reshape(4, 4), float(params[32])
    rng = np.random.default_rng(5)
    px, py = np.meshgrid(np.arange(4.0, W - 3, 8), np.arange(4.0, H - 3, 8))
    px = px.ravel()[:len(qs)] + rng.uniform(-0.5, 0.5, len(qs))
    py = py.ravel()[:len(qs)] + rng.uniform(-0.5, 0.5, len(qs))
    depth = r_num / (np.asarray(qs, np.float64) / 16.0)
    x = (2 * px / W - 1) * depth / pm[0, 0]
    y = (1 - 2 * py / H) * depth / pm[1, 1]
    pos = np.stack([x, y, -depth], 1).astype(np.float32)
    return torch.tensor(pos), torch.tensor(np.arange(len(qs)) % 5)


def test_emulated_kernels_equal_the_plain_version(splat_lib):
    """One 40x26 frame a case: the default pose; a camera inside the box
    facing a gallery of discs with radii from 0.6 to 3.8 px (every
    threshold of the 7x7 window met and missed) over a cloud, at
    footprints 7, 5 and 3, its positions read as a view of wider rows at
    7; a turned camera with points behind it and off screen, no border and
    int32 species."""
    cfg = reference_config()
    far, far_sp = _scene(400, 3, 5.0)
    near, near_sp = _scene(200, 4, 1.5)
    disc, disc_sp = _gallery(np.linspace(10, 60, 15).round())
    both, both_sp = torch.cat([disc, near]), torch.cat([disc_sp, near_sp])
    cases = [(far, far_sp, C.default_camera(10.0), {}),
             (both, both_sp, CLOSE, {"pos_stride": 9}),
             (both, both_sp, CLOSE, {"footprint": 5}),
             (both, both_sp, CLOSE, {"footprint": 3}),
             (near, near_sp.to(torch.int32), TURNED, {"draw_border": False})]
    background = _palette(cfg)[S.BACKGROUND_ID, :3]
    for pos, sp, cam, kw in cases:
        want = _plain(pos, sp, cfg, cam, W, H,
                      **{k: v for k, v in kw.items() if k != "pos_stride"})
        got = _emulated_frame(splat_lib, pos, sp, cfg, cam, W, H, **kw)
        assert (want != background).any(-1).mean() > 0.02
        np.testing.assert_array_equal(got, want, err_msg=f"{cam} {kw}")
