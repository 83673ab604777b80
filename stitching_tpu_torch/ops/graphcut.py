"""Grid min-cut by parallel push-relabel, for the graph-cut seams.

Port of `stitching_tpu/ops/graphcut.py`, batched over a leading pair axis
P (the reference vmaps it over the pairs of a bucket). Lock-step parallel
push-relabel on the 4-connected pixel grid:

- each iteration drains excess into the sink, pushes in the four
  directions in order (right, left, down, up; amount min(excess,
  residual) where the height drops by exactly 1), drains again and
  relabels (h = 1 + min over residual-positive neighbours);
- every `global_relabel_every` iterations the heights are reset by a BFS
  of residual distance to the sink;
- the source side of the cut is the set of pixels that cannot reach the
  sink in the residual graph (the same BFS).

Grids on the card go to one CUDA kernel a level
(`ops/kernels/push_relabel.py`), in which each pair runs its own loop to
its own end and the host reads one number. Grids on the CPU run
`_push_relabel`, the plain version, which the kernel equals exactly.

The reference's vmapped `while_loop` runs until no pair is active and
freezes the state of a pair once its own loop condition is false; the
plain version selects the new state only for the pairs still active, so
every pair's result is the one its own loop gives. The host reads whether
any pair is still active once every `CHECK_EVERY` iterations (capped so
the loop stops at exactly `max_iters`), and the BFS's `changed` flag once
every `CHECK_EVERY` steps: the BFS is at its fixed point once a step
changes nothing, and further steps leave it there. A stop can come up to
`CHECK_EVERY - 1` iterations after the last pair froze; those iterations
select nothing.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling as prof
from .kernels.push_relabel import LAUNCHES, push_relabel

INF = 1e18
_BIG_TERM = 1e8
# iterations (and BFS steps) between two host reads of the loop's end
CHECK_EVERY = 8

# directions: 0 right (+x), 1 left (-x), 2 down (+y), 3 up (-y)
_DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0))
_OPP = (1, 0, 3, 2)


def _shift(x, dy, dx, fill):
    """x (..., H, W) shifted by (dy, dx): out[y, x] = x[y - dy, x - dx],
    vacated cells set to `fill` (the reference's roll-and-fill)."""
    h, w = x.shape[-2], x.shape[-1]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def _neighbours(x, fill):
    """(..., 4, H, W): x at each pixel's neighbour in direction k (`fill`
    off the grid), i.e. `_shift(x, -dy, -dx, fill)` for every k."""
    h, w = x.shape[-2], x.shape[-1]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return torch.stack([p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                        for dy, dx in _DIRS], dim=-3)


def _residual_bfs_to_sink(pos, t_res, hmax):
    """Distance to the sink through the residual graph, capped at hmax.

    pos: (P, 4, H, W) bool, residual capacity > 0 in each direction;
    t_res: (P, H, W) residual terminal capacity to the sink. Returns the
    distances and the number of host reads."""
    d = torch.where(t_res > 0, 0.0, INF)
    reads = 0
    while True:
        for _ in range(CHECK_EVERY):
            cand = torch.where(pos, _neighbours(d, INF) + 1.0, INF)
            best = torch.minimum(d, cand.amin(dim=1))
            changed = (best < d).any()
            d = best
        reads += 1
        if not bool(changed):
            return torch.clamp_max(d, hmax), reads


def grid_min_cut(cap_dir, s_cap, t_cap, *, max_iters=2000,
                 global_relabel_every=64):
    """Min s-t cut on a 4-connected grid, for P grids at once.

    cap_dir: (P, 4, H, W) float32, the capacity of the edge from each pixel
    to its neighbour in direction k (right/left/down/up); out-of-grid edges
    must be 0. s_cap / t_cap: (P, H, W) terminal capacities.

    Returns (src_side (P, H, W) bool, stats): the pixels on the source side
    of each cut, and a dict with `iterations` (the reference's loop
    length: the most iterations any pair ran), `relabels` (the global
    relabels of that loop), `host_reads` (device-to-host reads of the loop
    and its BFS) and `launches` (kernel launches: 1 on the card, 0 on the
    CPU).

    Each call is a span `low/seam_find/cut` (it ends in a host read, so
    its fence adds no sync) and adds to the counters `gc/levels` (1),
    `gc/iterations`, `gc/host_reads` and `gc/cut_launches` (its stats).
    """
    with prof.stage_timer("low/seam_find/cut"):
        if s_cap.device.type == "cpu":
            src_side, stats = _push_relabel(cap_dir, s_cap, t_cap,
                                            max_iters, global_relabel_every)
        else:
            src_side, stats = _push_relabel_card(
                cap_dir, s_cap, t_cap, max_iters, global_relabel_every)
        prof.fence(src_side)
    prof.count("gc/levels")
    prof.count("gc/iterations", stats["iterations"])
    prof.count("gc/host_reads", stats["host_reads"])
    prof.count("gc/cut_launches", stats["launches"])
    return src_side, stats


def _push_relabel_card(cap_dir, s_cap, t_cap, max_iters,
                       global_relabel_every):
    """The level in one launch; the host reads the longest loop's length.
    That loop's global relabels come at its iterations 0, every, 2 every,
    ... below its length."""
    src_side, iters = push_relabel(
        cap_dir.to(torch.float32).contiguous(), s_cap.contiguous(),
        t_cap.contiguous(), max_iters, global_relabel_every)
    n = int(iters.max())
    return src_side, dict(iterations=n,
                          relabels=-(-n // global_relabel_every),
                          host_reads=1, launches=LAUNCHES)


def _push_relabel(cap_dir, s_cap, t_cap, max_iters, global_relabel_every):
    P, h, w = s_cap.shape
    dev = s_cap.device
    n_nodes = float(h * w + 2)
    hmax = 2.0 * n_nodes

    # cancel parallel terminal edges, then saturate source edges (preflow)
    common = torch.minimum(s_cap, t_cap)
    excess = s_cap - common
    t_res = t_cap - common
    res = cap_dir.to(torch.float32)
    height = torch.zeros((P, h, w), dtype=torch.float32, device=dev)
    iters = torch.zeros((P,), dtype=torch.int64, device=dev)
    stats = dict(iterations=0, relabels=0, host_reads=0, launches=0)

    def drain(excess, t_res):
        amt = torch.minimum(excess, t_res)
        return excess - amt, t_res - amt

    def step(i, res, excess, height, t_res):
        if i % global_relabel_every == 0:
            d, reads = _residual_bfs_to_sink(res > 0, t_res, hmax)
            stats["relabels"] += 1
            stats["host_reads"] += reads
            # source-disconnected nodes are parked at height n
            height = torch.where(d >= hmax,
                                 torch.clamp_min(height, n_nodes), d)
        excess, t_res = drain(excess, t_res)
        # heights stay fixed through the pushes and the relabel
        nh = _neighbours(height, INF)
        downhill = height[:, None] == nh + 1.0
        res = res.clone()
        for k, (dy, dx) in enumerate(_DIRS):
            rk = res[:, k]
            adm = (excess > 0) & (rk > 0) & downhill[:, k]
            amt = torch.where(adm, torch.minimum(excess, rk), 0.0)
            moved = _shift(amt, dy, dx, 0.0)
            excess = excess - amt
            excess = excess + moved
            rk.sub_(amt)
            res[:, _OPP[k]].add_(moved)
        excess, t_res = drain(excess, t_res)

        # relabel: active nodes with no admissible edge lift to 1 + the
        # lowest neighbour over positive-residual edges
        pos = res > 0
        minnh = torch.where(pos, nh, INF).amin(dim=1)
        minnh = torch.where(t_res > 0, torch.clamp_max(minnh, -1.0), minnh)
        active = (excess > 0) & (height < hmax)
        has_adm = (pos & downhill).any(dim=1) | (t_res > 0)
        lift = active & ~has_adm
        height = torch.where(lift, torch.clamp_max(minnh + 1.0, hmax),
                             height)
        return res, excess, height, t_res

    def live_of(excess, height):
        # the reference's loop condition, per pair
        return ((excess > 0) & (height < n_nodes)).flatten(1).any(dim=1)

    i = 0
    while i < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - i)):
            live = live_of(excess, height)
            new = step(i, res, excess, height, t_res)
            lv = live[:, None, None]
            res = torch.where(lv[:, None], new[0], res)
            excess = torch.where(lv, new[1], excess)
            height = torch.where(lv, new[2], height)
            t_res = torch.where(lv, new[3], t_res)
            iters += live
            i += 1
        stats["host_reads"] += 1
        if not bool(live_of(excess, height).any()):
            break

    # the min cut: the pixels that cannot reach the sink
    d, reads = _residual_bfs_to_sink(res > 0, t_res, hmax)
    stats["host_reads"] += reads + 1
    stats["iterations"] = int(iters.max())
    return d >= hmax, stats


def _grad_mag(a):
    """|g(x+1) - g(x-1)| + |g(y+1) - g(y-1)| of the channel mean g, the
    missing neighbours read as 0. a: (P, H, W, C)."""
    g = a[..., 0]
    for c in range(1, a.shape[-1]):
        g = g + a[..., c]
    # the reference's compiled mean multiplies by the float32 reciprocal
    g = g * float(np.float32(1.0 / a.shape[-1]))
    gx = (_shift(g, 0, -1, 0.0) - _shift(g, 0, 1, 0.0)).abs()
    gy = (_shift(g, -1, 0, 0.0) - _shift(g, 1, 0, 0.0)).abs()
    return gx + gy


def _pair_caps(img_i, img_j, both, only_i, only_j, use_grad):
    """Grid capacities for the overlap tiles (cv.GraphCutSeamFinder's
    COST_COLOR[_GRAD] form: a neighbour edge is the mean of the two pixel
    costs + 1; edges leaving the valid region are 0). img_*: (P, H, W, C);
    masks (P, H, W) bool. Returns (cap_dir, s_cap, t_cap)."""
    d = (img_i - img_j).abs()
    diff = d[..., 0]
    for c in range(1, d.shape[-1]):
        diff = diff + d[..., c]
    if use_grad:
        diff = diff + (_grad_mag(img_i) - _grad_mag(img_j)).abs()
    valid = both | only_i | only_j
    # 0.5 * s is exact, so a fused multiply-add rounds the same
    caps = torch.where(valid[:, None] & _neighbours(valid, False),
                       0.5 * (diff[:, None] + _neighbours(diff, 0.0)) + 1.0,
                       0.0)
    return (caps, torch.where(only_i, _BIG_TERM, 0.0),
            torch.where(only_j, _BIG_TERM, 0.0))


def _blocks4(x, fill):
    """(P, H, W, ...) padded to multiples of 4 with `fill` ("edge" when
    None) and viewed as (P, H/4, 4, W/4, 4, ...)."""
    P, h, w = x.shape[:3]
    hp, wp = -(-h // 4) * 4, -(-w // 4) * 4
    if fill is None:
        x = torch.cat([x, x[:, -1:].expand(P, hp - h, *x.shape[2:])], 1)
        x = torch.cat([x, x[:, :, -1:].expand(P, hp, wp - w,
                                              *x.shape[3:])], 2)
    else:
        x = torch.cat([x, torch.full((P, hp - h, *x.shape[2:]), fill,
                                     dtype=x.dtype, device=x.device)], 1)
        x = torch.cat([x, torch.full((P, hp, wp - w, *x.shape[3:]), fill,
                                     dtype=x.dtype, device=x.device)], 2)
    return x.reshape(P, hp // 4, 4, wp // 4, 4, *x.shape[3:])


def _down4_mean(x):
    """4x4 block means of (P, H, W, C), edge-padded; the 16 values summed
    one at a time, row by row (the reference's reduction order)."""
    b = _blocks4(x, None)
    acc = b[:, :, 0, :, 0]
    for k in range(1, 16):
        acc = acc + b[:, :, k // 4, :, k % 4]
    return acc / 16.0


def _down4_any(x):
    """4x4 block OR of (P, H, W) bool, padded with False."""
    return _blocks4(x, False).any(dim=4).any(dim=2)


def seam_cut_pair(img_i, img_j, both, only_i, only_j, use_grad, _depth=0):
    """Graph-cut seams for P overlap tiles of one shape, coarse to fine.

    img_i/img_j: (P, H, W, C) float32 overlap content; both/only_i/only_j:
    (P, H, W) bool. Returns own_i (P, H, W) bool: the contested pixels
    image i keeps. Where min(H, W) >= 128 (and above depth 3) the tiles
    are cut first at a quarter of the size, then the full-size cut runs
    with everything outside a +-12 px band around the upsampled coarse
    seam pinned to its coarse side.
    """
    h, w = both.shape[1], both.shape[2]
    cap_dir, s_cap, t_cap = _pair_caps(img_i, img_j, both, only_i, only_j,
                                       use_grad)
    if min(h, w) >= 128 and _depth < 3:
        c_oi = _down4_any(only_i)
        c_oj = _down4_any(only_j)
        # a coarse cell mixing both exclusive territories (or exclusive and
        # contested) is contested
        c_both = _down4_any(both) | (c_oi & c_oj)
        own_c = seam_cut_pair(_down4_mean(img_i), _down4_mean(img_j),
                              c_both, c_oi & ~c_both, c_oj & ~c_both,
                              use_grad, _depth + 1)
        up = own_c.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :h, :w]
        boundary = torch.zeros_like(up)
        for dy, dx in _DIRS:
            boundary = boundary | (up != _shift(up, dy, dx, False))
        band = F.max_pool2d(boundary[:, None].to(torch.float32), 25, 1,
                            12)[:, 0] > 0
        s_cap = torch.where(only_i | (both & up & ~band), _BIG_TERM, s_cap)
        t_cap = torch.where(only_j | (both & ~up & ~band), _BIG_TERM, t_cap)
    return grid_min_cut(cap_dir, s_cap, t_cap)[0]
