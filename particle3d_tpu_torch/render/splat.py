"""Point-splat rasterizer with an exact scatter-min z-buffer, on the
frame's device (port of ``particle3d_tpu.render.splat``).

Particles render as depth-tested circular splats of world-space size ~0.1,
coloured by species. (depth, colour id) pack into one int32 a pixel; the
bits of a positive float32 are monotonic, so a scatter-min over packed
keys (``scatter_reduce_(..., "amin")``) is the depth test, deterministic
in one op. Keys of pixels off screen go to one sentinel slot past the
image. The world-box wireframe is drawn as depth-tested line splats along
the box's 12 edges.

Two methods, as in the JAX package:

* ``"scatter"``: every splat writes its whole footprint (footprint^2
  pixels), 24-bit depth keys;
* ``"dilate"`` (default): every splat writes one key
  [depth:15 | radius*16:8 | colour:8] to its 2x2 nearest pixels, and an
  elementwise dilation over shifted views of one padded image rebuilds
  the discs, taking at each pixel the least key whose radius reaches it.
  Coverage is judged from the seed pixel's centre (<= 0.5 px off) with
  the radius in 1/16 px; when several splats seed one pixel only the
  nearest survives there.

The JAX renderer is XLA ops, not a Pallas kernel; this port is plain
torch. Projection runs as separate elementwise ops (no matmul), so it
rounds the same on the CPU and on the card, whatever the TF32 setting.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..utils.profiling import host_sync
from .camera import Camera, projection_matrix, view_matrix

BORDER_COLOR_ID = 254
BACKGROUND_ID = 255
SPRITE_WORLD_SIZE = 0.1  # view-space quad side
_EMPTY = 0x7FFFFFFF

_DEPTH_SHIFT = 16
_R_SHIFT = 8
_R_SCALE = 16.0


def _affine(points, m):
    """Rows of ``m @ [p; 1]`` for points [M, 3]: each output coordinate
    summed left to right in separate ops."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return [x * m[r, 0] + y * m[r, 1] + z * m[r, 2] + m[r, 3] for r in range(4)]


def _project(points, vm, pm):
    """world [M, 3] -> (pixel xy [M, 2] in the unit square, depth01 [M],
    in_front [M], view-space depth [M], positive ahead)."""
    viewp = _affine(points, vm)
    vx, vy, vz, vw = viewp
    clip = [vx * pm[r, 0] + vy * pm[r, 1] + vz * pm[r, 2] + vw * pm[r, 3]
            for r in range(4)]
    w = clip[3]
    in_front = w > 1e-6
    w = torch.where(in_front, w, 1.0)
    ndc = [c / w for c in clip[:3]]
    xy = torch.stack([(ndc[0] + 1.0) * 0.5, (1.0 - ndc[1]) * 0.5], dim=1)
    depth01 = torch.clamp(ndc[2] * 0.5 + 0.5, 0.0, 1.0)
    return xy, depth01, in_front, -vz


def _pack_keys(depth01, color_id):
    """Monotonic (depth, colour) key: high 24 bits the depth's float bits."""
    bits = depth01.to(torch.float32).view(torch.int32)
    return (bits & ~0xFF) | color_id.to(torch.int32)


def _scatter_min(buf, lin, keys):
    return buf.scatter_reduce_(0, lin.reshape(-1), keys.reshape(-1), "amin")


def _splat(buf, xy, depth01, color_id, alive, width, height, radius_px,
           footprint):
    """Scatter-min splats of pixel radius ``radius_px`` into ``buf``."""
    dev = xy.device
    px = xy[:, 0] * width
    py = xy[:, 1] * height
    keys = _pack_keys(depth01, color_id)
    half = footprint // 2
    offs = torch.arange(-half, half + 1, device=dev, dtype=torch.float32)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")  # ox along columns
    ox, oy = ox.reshape(-1), oy.reshape(-1)
    cx = torch.floor(px)[:, None] + ox[None, :]
    cy = torch.floor(py)[:, None] + oy[None, :]
    ex = cx + 0.5 - px[:, None]
    ey = cy + 0.5 - py[:, None]
    inside = ex * ex + ey * ey <= (radius_px * radius_px)[:, None]
    onscreen = (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
    ok = inside & onscreen & alive[:, None]
    lin = torch.where(ok, cy * width + cx, float(width * height)).to(torch.int64)
    return _scatter_min(buf, lin, keys[:, None].expand(ok.shape))


def _box_edge_points(world_size, samples: int, device):
    """[12 * samples, 3] points along the world box's edges."""
    h = float(np.float32(world_size) * np.float32(0.5))
    t = torch.linspace(-1.0, 1.0, samples, device=device)
    pts = []
    for axis in range(3):
        for s1 in (-1.0, 1.0):
            for s2 in (-1.0, 1.0):
                e = [None, None, None]
                e[axis] = t * h
                e[(axis + 1) % 3] = torch.full_like(t, s1 * h)
                e[(axis + 2) % 3] = torch.full_like(t, s2 * h)
                pts.append(torch.stack(e, dim=1))
    return torch.cat(pts)


def _pack_fast_keys(view_z, r_px, color_id):
    """[depth:15 | radius:8 | colour:8], depth the top 15 bits of the
    positive view-space distance's float32 bits (monotonic, ~2^-7 relative
    resolution at every scale)."""
    bits = torch.clamp(view_z, min=1e-6).to(torch.float32).view(torch.int32)
    d = bits >> 16
    q = torch.clamp(torch.round(r_px * _R_SCALE), 0, 255).to(torch.int32)
    return (d << _DEPTH_SHIFT) | (q << _R_SHIFT) | color_id.to(torch.int32)


def _seed_points(buf, xy, view_z, r_px, color_id, alive, width, height):
    """Scatter each splat's packed key to its 2x2 nearest pixels."""
    px = xy[:, 0] * width
    py = xy[:, 1] * height
    keys = _pack_fast_keys(view_z, r_px, color_id)
    ix0 = torch.floor(px - 0.5)
    iy0 = torch.floor(py - 0.5)
    lins = []
    for dx in (0, 1):
        for dy in (0, 1):
            cx, cy = ix0 + dx, iy0 + dy
            ok = alive & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
            lins.append(torch.where(ok, cy * width + cx, float(width * height)))
    lin = torch.stack(lins, 1).to(torch.int64)
    return _scatter_min(buf, lin, keys[:, None].expand(lin.shape))


def _dilate(seeds, height, width, footprint):
    """Least key over the shifted seed images whose radius covers the pixel."""
    half = footprint // 2
    pad = torch.nn.functional.pad(seeds, (half, half, half, half),
                                  value=_EMPTY)
    out = seeds
    empty = torch.full((), _EMPTY, dtype=torch.int32, device=seeds.device)
    rmask = 0xFF << _R_SHIFT
    for oy in range(-half, half + 1):
        for ox in range(-half, half + 1):
            if ox == 0 and oy == 0:
                continue
            thr = int(round((ox * ox + oy * oy) ** 0.5 * _R_SCALE))
            if thr > 255:
                continue  # beyond the largest representable radius
            cand = pad[half + oy:half + oy + height, half + ox:half + ox + width]
            covered = (cand & rmask) >= (thr << _R_SHIFT)
            out = torch.minimum(out, torch.where(covered, cand, empty))
    return out


def _decode(img_keys, cfg: SimConfig):
    ids = torch.where(img_keys == _EMPTY, BACKGROUND_ID, img_keys & 0xFF)
    palette = np.zeros((256, 3), np.float32)
    colors = np.asarray(cfg.colors, np.float32)
    palette[:colors.shape[0]] = colors
    palette[BORDER_COLOR_ID] = 0.6
    palette[BACKGROUND_ID] = [0.02, 0.02, 0.03]
    # a blocking copy from the host: it waits for the frame's queued work
    with host_sync("sync.render_palette"):
        pal = torch.as_tensor(palette, device=img_keys.device)
    img = pal[ids.to(torch.int64)]
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_frame(positions, species, cfg: SimConfig, cam: Camera,
                 width: int = 640, height: int = 480, *, footprint: int = 7,
                 draw_border: bool = True, border_samples: int = 128,
                 method: str = "dilate"):
    """One frame on ``positions``' device -> uint8 tensor [H, W, 3].

    positions [N, 3], species [N] (tensors on one device); colours come
    from ``cfg.colors``. ``method``: "dilate" (default) or "scatter"
    (module docstring)."""
    if method not in ("dilate", "scatter"):
        raise ValueError(f"unknown render method {method!r}")
    dev = positions.device
    # blocking copies from the host
    with host_sync("sync.render_upload"):
        vm = torch.as_tensor(view_matrix(cam), device=dev)
    with host_sync("sync.render_upload"):
        pm = torch.as_tensor(projection_matrix(cam, width / height),
                             device=dev)
    fov = np.deg2rad(np.float32(cam.fov_deg))
    focal_px = np.float32(height * 0.5) / np.tan(fov / np.float32(2.0))
    # the splat radius' numerator, rounded to float32 as the JAX package's
    # traced product is, and divided as a tensor (torch divides a host
    # scalar by a tensor as a multiply by the reciprocal)
    r_num = torch.full((), float(np.float32(SPRITE_WORLD_SIZE * 0.5) * focal_px),
                       device=dev)
    buf = torch.full((width * height + 1,), _EMPTY, dtype=torch.int32,
                     device=dev)

    if draw_border:
        bp = _box_edge_points(cfg.world_size, border_samples, dev)
        xy, d01, front, vz = _project(bp, vm, pm)
        one = torch.ones(bp.shape[0], device=dev)
        border = torch.full((bp.shape[0],), BORDER_COLOR_ID, device=dev)
        if method == "scatter":
            buf = _splat(buf, xy, d01, border, front, width, height, one, 3)
        else:
            buf = _seed_points(buf, xy, vz, one, border, front, width, height)

    xy, d01, front, vz = _project(positions.to(torch.float32), vm, pm)
    r_px = r_num / torch.clamp(vz, min=1e-6)
    # min radius > sqrt(2)/2: a sub-pixel splat centred on a pixel corner
    # still covers one pixel centre
    r_px = torch.clamp(r_px, 0.75, footprint / 2.0)
    if method == "scatter":
        buf = _splat(buf, xy, d01, species, front, width, height, r_px,
                     footprint)
        return _decode(buf[:-1].reshape(height, width), cfg)
    buf = _seed_points(buf, xy, vz, r_px, species, front, width, height)
    seeds = buf[:-1].reshape(height, width)
    return _decode(_dilate(seeds, height, width, footprint), cfg)
