"""The splat renderer's image as its stated method defines it, in plain
PyTorch (float64 geometry).

The camera (the reference's ``CameraSystem``): forward = (cos p sin y,
sin p, -cos p cos y), right = forward x world-up, up = right x forward; a
look-to view matrix and an OpenGL perspective (fovy, aspect, near, far).
Each particle seeds its 2x2 nearest pixels (floor(px - 0.5) + {0, 1}) with
the key [depth:15 | radius:8 | colour:8]: the top 15 bits of its view
depth's float32 bits, its pixel radius (a 0.1-unit sprite at the focal
length, clamped to [0.75, footprint / 2]) in sixteenths, its species.
The world box's 12 edges, sampled at ``border_samples`` points each, seed
radius-1 keys of colour 254. A pixel takes the least key among its own
seed and every seed within the footprint whose radius reaches it
(rounded distance in sixteenths); an unseeded pixel is the background.
Colours: the species' palette, 254 grey 0.6, the background (0.02, 0.02,
0.03), times 255 truncated to bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EMPTY = 0x7FFFFFFF
BORDER, BACKGROUND = 254, 255


def _axes(pitch_deg, yaw_deg):
    p, y = math.radians(pitch_deg), math.radians(yaw_deg)
    f = np.array([math.cos(p) * math.sin(y), math.sin(p),
                  -math.cos(p) * math.cos(y)])
    f /= np.linalg.norm(f)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    return f, r, u / np.linalg.norm(u)


def matrices(camera: dict, aspect: float):
    """(view, projection) as float64 [4, 4] arrays."""
    f, _, up = _axes(camera["pitch"], camera["yaw"])
    eye = np.asarray(camera["position"], np.float64)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.array([[*s, -s @ eye], [*u, -u @ eye], [*-f, f @ eye],
                     [0.0, 0.0, 0.0, 1.0]])
    fct = 1.0 / math.tan(math.radians(camera["fov_deg"]) / 2)
    near, far = camera["near"], camera["far"]
    proj = np.array([[fct / aspect, 0, 0, 0], [0, fct, 0, 0],
                     [0, 0, (far + near) / (near - far),
                      2 * far * near / (near - far)], [0, 0, -1.0, 0]])
    return view, proj


def _keys(depth, radius_px, colour):
    bits = depth.clamp(min=1e-6).to(torch.float32).view(torch.int32) >> 16
    q = torch.clamp(torch.round(radius_px * 16), 0, 255).to(torch.int32)
    return (bits << 16) | (q << 8) | colour.to(torch.int32)


def render(positions, species, colors, world: float, camera: dict,
           width: int, height: int, footprint: int = 7,
           border_samples: int = 128) -> torch.Tensor:
    """uint8 [H, W, 3] on ``positions``' device."""
    dev = positions.device
    view, proj = matrices(camera, width / height)
    m = torch.as_tensor(proj @ view, dtype=torch.float64, device=dev)
    v = torch.as_tensor(view, dtype=torch.float64, device=dev)
    focal = (height / 2) / math.tan(math.radians(camera["fov_deg"]) / 2)
    buf = torch.full((width * height + 1,), EMPTY, dtype=torch.int32,
                     device=dev)

    def seed(pts, radius_px, colour):
        hom = torch.cat([pts.double(), torch.ones_like(pts[:, :1]).double()], 1)
        clip = hom @ m.T
        depth = -(hom @ v[2])
        w = clip[:, 3]
        front = w > 1e-6
        w = torch.where(front, w, torch.ones_like(w))
        px = (clip[:, 0] / w + 1) * 0.5 * width
        py = (1 - clip[:, 1] / w) * 0.5 * height
        r = radius_px(depth)
        key = _keys(depth, r, colour)
        x0, y0 = torch.floor(px - 0.5), torch.floor(py - 0.5)
        for dx in (0, 1):
            for dy in (0, 1):
                cx, cy = x0 + dx, y0 + dy
                ok = front & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
                lin = torch.where(ok, cy * width + cx,
                                  torch.full_like(cx, width * height))
                buf.scatter_reduce_(0, lin.long(), key, "amin")

    h = world / 2
    t = torch.linspace(-1.0, 1.0, border_samples, dtype=torch.float64,
                       device=dev) * h
    edges = []
    for axis in range(3):
        for s1 in (-h, h):
            for s2 in (-h, h):
                e = [None] * 3
                e[axis] = t
                e[(axis + 1) % 3] = torch.full_like(t, s1)
                e[(axis + 2) % 3] = torch.full_like(t, s2)
                edges.append(torch.stack(e, 1))
    edges = torch.cat(edges)
    seed(edges, lambda d: torch.ones_like(d),
         torch.full((edges.shape[0],), BORDER, device=dev))
    seed(positions, lambda d: torch.clamp(0.05 * focal / d.clamp(min=1e-6),
                                          0.75, footprint / 2), species)

    seeds = buf[:-1].reshape(height, width)
    half = footprint // 2
    pad = torch.full((height + 2 * half, width + 2 * half), EMPTY,
                     dtype=torch.int32, device=dev)
    pad[half:half + height, half:half + width] = seeds
    out = seeds.clone()
    for oy in range(-half, half + 1):
        for ox in range(-half, half + 1):
            thr = int(round(math.sqrt(ox * ox + oy * oy) * 16))
            if (ox, oy) == (0, 0) or thr > 255:
                continue
            cand = pad[half + oy:half + oy + height, half + ox:half + ox + width]
            reach = (cand & 0xFF00) >= (thr << 8)
            out = torch.minimum(out, torch.where(reach, cand,
                                                 torch.full_like(cand, EMPTY)))
    ids = torch.where(out == EMPTY, BACKGROUND, out & 0xFF).long()
    palette = torch.zeros((256, 3), dtype=torch.float32)
    cols = torch.as_tensor(np.asarray(colors, np.float32))
    palette[:cols.shape[0]] = cols
    palette[BORDER] = 0.6
    palette[BACKGROUND] = torch.tensor([0.02, 0.02, 0.03])
    img = palette.to(dev)[ids]
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
