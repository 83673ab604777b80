"""View sets made on the device from a seed, with their true geometry.

A traffic file (`traffic/<name>.json`) names one of the generators below
under `generator` and gives its parameters. Every generator draws from a
`torch.Generator` on the device it is given, so one seed gives the same
views, and returns the views as host uint8 (H, W, 3) arrays (what
`Stitcher.stitch` takes) beside the truth that the reference judges the
registration by.

`shrink` scales every length (views, focal, scene, offsets) for the CPU
tests; the benchmark itself always runs at 1.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def set_seed(seed, k):
    """The seed of the k-th view set of a run: a 32-bit draw from a
    SeedSequence, so seeds of any size (beyond 32 bits too)
    give distinct, reproducible sets."""
    return int(np.random.SeedSequence([int(seed), int(k)])
               .generate_state(1)[0])


def textured_scene(h, w, blocks, gen, device):
    """`chip_smoke.textured_scene` on the device: a flat base colour,
    `blocks` corner-rich rectangles each blended half into what is under
    it, two low-frequency gradients, then a 5-tap Gaussian blur (sigma
    1.2, reflected borders). Returns a (3, h, w) float32 tensor of whole
    numbers in 0..255."""
    base = torch.rand(3, generator=gen, device=device) * 40 + 40
    img = base.view(3, 1, 1).expand(3, h, w).clone()
    r = torch.rand(blocks, 7, generator=gen, device=device,
                   dtype=torch.float64)
    colors = (r[:, 4:7] * 255).to(torch.float32)
    geo = r[:, :4].cpu().numpy()
    xs = (geo[:, 0] * (w - 10)).astype(np.int64)
    ys = (geo[:, 1] * (h - 10)).astype(np.int64)
    bws = 4 + (geo[:, 2] * 56).astype(np.int64)
    bhs = 4 + (geo[:, 3] * 56).astype(np.int64)
    for k in range(blocks):
        x, y, bw, bh = int(xs[k]), int(ys[k]), int(bws[k]), int(bhs[k])
        patch = img[:, y:y + bh, x:x + bw]
        patch.mul_(0.5).add_(0.5 * colors[k].view(3, 1, 1))
    yy = torch.arange(h, device=device, dtype=torch.float32)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    img[0] += 20 * torch.sin(xx / 97.0)[None, :]
    img[1] += 20 * torch.cos(yy / 71.0)[:, None]
    img = img.clamp(0, 255).floor()
    k = torch.exp(-torch.arange(-2, 3, device=device,
                                dtype=torch.float32) ** 2 / (2 * 1.2 ** 2))
    k = k / k.sum()
    x = img[None]
    x = F.conv2d(F.pad(x, (2, 2, 0, 0), mode="reflect"),
                 k.view(1, 1, 1, 5).expand(3, 1, 1, 5), groups=3)
    x = F.conv2d(F.pad(x, (0, 0, 2, 2), mode="reflect"),
                 k.view(1, 1, 5, 1).expand(3, 1, 5, 1), groups=3)
    return x[0].round().clamp(0, 255)


def _scene(p, gen, device, shrink):
    s = p["scene"]
    h = max(16, int(round(s["height"] * shrink)))
    w = max(16, int(round(s["width"] * shrink)))
    # a shrunken scene keeps the blocks' size and density
    blocks = max(1, int(round(s["blocks"] * shrink ** 2)))
    scene = textured_scene(h, w, blocks, gen, device)
    scale = s.get("scale", 1.0)
    if scale != 1.0:
        scene = F.interpolate(scene[None], scale_factor=scale,
                              mode="bilinear", align_corners=False)[0]
        scene = scene.round().clamp(0, 255)
    return scene


def _to_host(img_chw):
    return np.ascontiguousarray(
        img_chw.permute(1, 2, 0).to(torch.uint8).cpu().numpy())


def _sphere_coords(rays, f, sw, sh):
    """Texture coordinates of world rays (..., 3): the texture lies on a
    sphere around the camera, `f` texture pixels to the radian, its
    centre straight ahead: column sw/2 + f * longitude, row sh/2 + f *
    latitude."""
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    lon = torch.atan2(x, z)
    lat = torch.atan2(y, torch.sqrt(x * x + z * z))
    return sw / 2 + f * lon, sh / 2 + f * lat


def grid_order(rows, cols):
    """(row, column) of each view of a capture of `rows` x `cols` in the
    order it is shot: serpentine, row 0 left to right, row 1 right to
    left, and so on, as a pan-tilt head or a hand sweeps row after row."""
    return [(r, c if r % 2 == 0 else cols - 1 - c)
            for r in range(rows) for c in range(cols)]


def grid_pairs(rows, cols):
    """Every pair of grid neighbours (the same row and adjacent columns,
    or the same column and adjacent rows) as view indices (i, j), i < j,
    in `grid_order`."""
    at = {rc: i for i, rc in enumerate(grid_order(rows, cols))}
    pairs = [(at[r, c], at[r, c + 1]) for r in range(rows)
             for c in range(cols - 1)]
    pairs += [(at[r, c], at[r + 1, c]) for r in range(rows - 1)
              for c in range(cols)]
    return sorted(tuple(sorted(p)) for p in pairs)


def rotation(p, seed, device, shrink=1.0):
    """`views` views from a purely rotating camera of a textured scene on
    a sphere around it, as far away in every direction (as a panorama's
    scene is, seen from where the camera turns): each pixel's ray R K^-1 p
    looks the texture up at its longitude and latitude, `focal` texture
    pixels to the radian (bilinear), so the texture is as sharp at the
    views' edges as at their centres. Any two views are related by the
    homography K R_j^T R_i K^-1 of a pure rotation.

    The views lie on a grid of `rows` (default 1) rows of `views / rows`
    columns, in `grid_order`: yaw evenly over +-`max_angle` rad in each
    row, pitch evenly over +-`max_pitch` rad (default 0) across the rows,
    camera to world R = R_yaw R_pitch. One row is a sweep in yaw alone.

    The scene, drawn before any view, has to hold every view whole, so
    that no view has a black band: a traffic whose scene is too small
    raises ValueError. Truth: K (full resolution), each camera's rotation,
    camera to world, and for more than one row `pairs`, every pair of
    grid neighbours (`grid_pairs`)."""
    rows = p.get("rows", 1)
    if p["views"] % rows:
        raise ValueError(f"{p['views']} views do not make {rows} rows")
    cols = p["views"] // rows
    gen = torch.Generator(device=device).manual_seed(seed)
    w = int(round(p["width"] * shrink))
    h = int(round(p["height"] * shrink))
    f = p["focal"] * shrink
    scene = _scene(p, gen, device, shrink)
    sh, sw = scene.shape[1:]
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device),
        torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    yaws = np.linspace(-p["max_angle"], p["max_angle"], cols)
    pitches = np.linspace(-p.get("max_pitch", 0.0), p.get("max_pitch", 0.0),
                          rows)
    views, Rs = [], []
    for r, c in grid_order(rows, cols):
        c_y, s_y = math.cos(yaws[c]), math.sin(yaws[c])
        c_p, s_p = math.cos(pitches[r]), math.sin(pitches[r])
        R = (np.array([[c_y, 0, s_y], [0, 1, 0], [-s_y, 0, c_y]])
             @ np.array([[1, 0, 0], [0, c_p, -s_p], [0, s_p, c_p]]))
        rays = pix @ torch.as_tensor((R @ np.linalg.inv(K)).T,
                                     device=device)
        sx, sy = _sphere_coords(rays, f, sw, sh)
        if (float(sx.min()) < 0 or float(sx.max()) > sw - 1
                or float(sy.min()) < 0 or float(sy.max()) > sh - 1):
            raise ValueError(f"the scene of {sw}x{sh} does not hold the "
                             f"view at yaw {yaws[c]:.3f}, pitch "
                             f"{pitches[r]:.3f}")
        grid = torch.stack([2 * sx / (sw - 1) - 1, 2 * sy / (sh - 1) - 1],
                           -1).to(torch.float32)[None]
        out = F.grid_sample(scene[None], grid, mode="bilinear",
                            padding_mode="zeros", align_corners=True)[0]
        views.append(_to_host(out.round().clamp(0, 255)))
        Rs.append(R)
        del rays, sx, sy, grid, out
    truth = dict(kind="rotation", K=K, Rs=Rs)
    if rows > 1:
        truth["pairs"] = grid_pairs(rows, cols)
    return views, truth


def scan(p, seed, device, shrink=1.0):
    """`views` crops of one textured scene, each `step` of the width right
    of the last and every other one `drop` px lower (a flatbed, document or
    drone-strip scan), as `chip_smoke.scan_set` cuts them; the scene as
    dense in blocks as the rotation scene. Truth: each crop's (x, y)
    offset in the scene, full resolution."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = int(round(p["width"] * shrink))
    h = int(round(p["height"] * shrink))
    n = p["views"]
    step = int(w * p["step"])
    drop = int(round(p["drop"] * shrink))
    margin = int(round(40 * shrink))
    sh, sw = h + 2 * margin, step * (n - 1) + w + 2 * margin
    blocks = int(p["blocks_per_mp"] * sh * sw / 1e6)
    scene = textured_scene(sh, sw, blocks, gen, device)
    offsets = [(margin + i * step, margin + (i % 2) * drop)
               for i in range(n)]
    views = [_to_host(scene[:, y:y + h, x:x + w]) for x, y in offsets]
    return views, dict(kind="scan", offsets=offsets)


GENERATORS = {"rotation": rotation, "scan": scan}


def make(traffic, seed, device, shrink=1.0):
    """The view set of `seed` for a traffic mix: (views, truth)."""
    return GENERATORS[traffic["generator"]](traffic, seed, device, shrink)
