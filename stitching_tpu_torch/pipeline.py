"""Batched stitching stages on the card: stacks, resize, detect, match.

Port of `stitching_tpu/pipeline.py`. Every stage operates on a stacked batch
living in device memory:

- all images upload ONCE as a padded (B, H, W, C) stack (uint8 over the
  link, widened to float32 on the card);
- per-resolution resizes are one batched gather over the stack;
- detection runs once over the whole batch (`DETECTORS`: ORB, SIFT,
  BRISK or AKAZE over (B, H, W) planes);
- matching + RANSAC runs the whole C(B,2) pair axis at once: the 2-NN is
  the CUDA kernel `ops/kernels/two_nn.two_nn_pairs`, ratio/union and
  RANSAC (homography, or the similarity for the affine matcher) are
  batched over pairs; the profiler's counter `match/pairs` takes the
  candidate pairs of each call;
- `register_pair` registers ONE pair of frames (detect, `match_pair`,
  RANSAC): the per-pair unit the match graph is built from.

Stacks pad to multiples of 64; true per-image sizes ride along as host
metadata. Under a mesh (`parallel.mesh`) the batch pads to a multiple of
the rank count (`pad_batch`; padded slots are size (1, 1)) and each rank
holds one contiguous block of it, while the sizes stay whole on the host;
detection gathers every rank's fields, and matching splits the pair axis
over the ranks and gathers the results.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from . import profiling as prof
from .ops.color import bgr_to_gray
from .ops.fma import fma
from .ops.kernels.two_nn import two_nn_pairs
from .ops.match import match_pair, ratio_union
from .ops.akaze import detect_akaze
from .ops.brisk import detect_brisk
from .ops.orb import detect_orb
from .ops.sift import detect_sift
from .ops.ransac import (N_HYPOTHESES, ransac_affine_partial,
                         ransac_homography)
from .parallel.mesh import all_gather_leading, shard_leading

_BUCKET = 64
# the detector of each `FeatureDetector` choice, over (B, H, W) planes
DETECTORS = dict(orb=detect_orb, sift=detect_sift, brisk=detect_brisk,
                 akaze=detect_akaze)


def _round_up(x, m=_BUCKET):
    return int(-(-x // m) * m)


def pad_sizes(sizes, b):
    """`sizes` ((w, h) each) over `b` batch slots, as a stack pads them:
    the slots past the images (1, 1)."""
    out = np.ones((b, 2), np.int32)
    out[:len(sizes)] = np.asarray(sizes, np.int32)
    return out


def pad_batch(n, mesh):
    """Smallest padded batch length: a multiple of the mesh size (>= n)."""
    if mesh is None:
        return n
    return -(-n // mesh.size) * mesh.size


# ---------------------------------------------------------------------------
# Image stacks
# ---------------------------------------------------------------------------

class RankBlock:
    """The leading axis of a stack that may be split over a mesh: `data`
    holds this rank's block of `batch` entries, starting at `lo`."""

    @property
    def batch(self):
        b = self.data.shape[0]
        return b if self.mesh is None else b * self.mesh.size

    @property
    def lo(self):
        """Index of this rank's first entry (0 without a mesh)."""
        return 0 if self.mesh is None else self.mesh.block(self.batch)[0]

    def _row(self, i):
        """Row of entry i in `data`; IndexError unless this rank holds i."""
        lo = self.lo
        if not lo <= i < lo + self.data.shape[0]:
            raise IndexError(f"entry {i} is not in this rank's block "
                             f"[{lo}, {lo + self.data.shape[0]})")
        return i - lo


@dataclasses.dataclass(frozen=True)
class DeviceStack(RankBlock):
    """A batch of images padded to one shape, resident on the card.

    data: (B, H, W, C) float32; per-image true content occupies
    [0:h_i, 0:w_i] (bottom/right padding is edge-replication).
    sizes: host (B, 2) int array of true (w, h).
    mesh: None, or the `parallel.mesh.Mesh` the batch is split over: then
    `data` holds this rank's block of B / D images, [lo, hi), and `sizes`
    all B.
    """

    data: torch.Tensor
    sizes: np.ndarray
    mesh: object = None

    @property
    def local_sizes(self):
        """Sizes of the images in `data`."""
        return self.sizes[self.lo:self.lo + self.data.shape[0]]

    def image(self, i):
        """Host copy of image i, cropped to its true size (float32); under
        a mesh, one of this rank's block."""
        row = self._row(i)
        w, h = self.sizes[i]
        return self.data[row, :h, :w].cpu().numpy()


@contextlib.contextmanager
def no_tf32():
    """Full float32 products and convolutions for the block, as the
    reference computes: cuBLAS's and cuDNN's float32 paths may use TF32
    unless told not to, which would perturb the ORB scores and the camera
    math. The caller's settings are restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def empty_stack(sizes, chans, device):
    """A stack for images of `sizes` ((w, h) each), padded as
    `stack_images` pads; its data is left for the caller to write."""
    sizes = np.asarray(sizes, np.int32).reshape(-1, 2)
    data = torch.empty((len(sizes), _round_up(int(sizes[:, 1].max())),
                        _round_up(int(sizes[:, 0].max())), chans),
                       dtype=torch.float32, device=device)
    return DeviceStack(data, sizes)


def stack_images(imgs, device="cuda", mesh=None):
    """Upload a list of HxW[xC] uint8/float images as one padded stack.

    uint8 inputs transfer as uint8 (4x less host->device traffic) and
    widen to float32 on the card. With a mesh the batch pads to
    `pad_batch` (padded slots are zero images of size (1, 1)) and this
    rank uploads only its block, to `mesh.device`.
    """
    arrs = [np.asarray(im) for im in imgs]
    chans = 3 if any(a.ndim == 3 for a in arrs) else 1
    hp = _round_up(max(a.shape[0] for a in arrs))
    wp = _round_up(max(a.shape[1] for a in arrs))
    b = pad_batch(len(arrs), mesh)
    lo, hi = (0, b) if mesh is None else mesh.block(b)
    u8 = all(a.dtype == np.uint8 for a in arrs)
    out = np.zeros((hi - lo, hp, wp, chans), np.uint8 if u8 else np.float32)
    sizes = np.ones((b, 2), np.int32)
    for i, a in enumerate(arrs):
        h, w = a.shape[:2]
        sizes[i] = (w, h)
        if not lo <= i < hi:
            continue
        if a.ndim == 2:
            a = a[..., None]
        if a.shape[2] == 1 and chans == 3:
            a = np.repeat(a, 3, axis=2)
        k = i - lo
        out[k, :h, :w] = a
        # edge-replicate so downstream bilinear taps never mix in zeros
        out[k, h:, :w] = out[k, h - 1: h, :w]
        out[k, :, w:] = out[k, :, w - 1: w]
    if mesh is not None:
        device = mesh.device
    data = torch.from_numpy(out).to(device).to(torch.float32)
    return DeviceStack(data, sizes, mesh)


def _resize_coords(n_out, in_len, out_len, limit):
    """Half-pixel source positions for every image: (B, n_out) lower tap,
    upper tap and lerp weight (float32, as `_resize_kernel` computes them)."""
    dev = in_len.device
    s = in_len / out_len                                        # (B,)
    pos = fma(torch.arange(n_out, dtype=torch.float32, device=dev)[None]
              + 0.5, s[:, None], -0.5)
    pos = torch.minimum(torch.clamp_min(pos, 0.0), in_len[:, None] - 1.0)
    p0 = torch.floor(pos)
    i0 = p0.long().clamp(0, limit - 1)
    i1 = (i0 + 1).clamp_max(limit - 1)
    return i0, i1, pos - p0


def resize_stack(stack: DeviceStack, out_sizes) -> DeviceStack:
    """Resize every image in the stack to its own (w, h) in `out_sizes`:
    batched per-image bilinear with half-pixel centers; output content
    occupies [0:out_h_i, 0:out_w_i] with clamp-replicated padding beyond."""
    out_sizes = np.asarray(out_sizes, np.int32)
    if np.array_equal(out_sizes, stack.sizes):
        return stack
    data = stack.data
    B, H, W, C = data.shape
    dev = data.device
    # one padded shape on every rank of a mesh: from all the sizes
    oh = _round_up(int(out_sizes[:, 1].max()))
    ow = _round_up(int(out_sizes[:, 0].max()))
    lo = stack.lo
    isz = torch.as_tensor(stack.local_sizes, dtype=torch.float32,
                          device=dev)
    osz = torch.as_tensor(out_sizes[lo:lo + B], dtype=torch.float32,
                          device=dev)
    x0, x1, fx = _resize_coords(ow, isz[:, 0], osz[:, 0], W)
    y0, y1, fy = _resize_coords(oh, isz[:, 1], osz[:, 1], H)
    bi = torch.arange(B, device=dev)[:, None, None]

    def tap(yy, xx):
        return data[bi, yy[:, :, None], xx[:, None, :]]        # (B,oh,ow,C)

    fx = fx[:, None, :, None]
    fy = fy[:, :, None, None]
    r0 = fma(tap(y0, x0), 1 - fx, tap(y0, x1) * fx)
    r1 = fma(tap(y1, x0), 1 - fx, tap(y1, x1) * fx)
    return DeviceStack(fma(r0, 1 - fy, r1 * fy), out_sizes, stack.mesh)


# ---------------------------------------------------------------------------
# Batched detection
# ---------------------------------------------------------------------------

def detect_stack(stack: DeviceStack, *, nfeatures, variant="orb",
                 feature_masks=None):
    """Detect keypoints on every image of the stack at once (under a
    mesh, on this rank's block; `feature_masks` lists every image).

    Returns a dict of stacked tensors: xy (B,N,2), response (B,N),
    size (B,N), angle_deg (B,N), desc (B,N,D), valid (B,N).
    """
    data = stack.data
    dev = data.device
    B, h, w = data.shape[0], data.shape[1], data.shape[2]
    gray = bgr_to_gray(data) if data.shape[-1] == 3 else data[..., 0]
    sizes = torch.as_tensor(stack.local_sizes, device=dev)
    cols = torch.arange(w, device=dev)[None, None, :]
    rows = torch.arange(h, device=dev)[None, :, None]
    region = ((cols < sizes[:, 0][:, None, None])
              & (rows < sizes[:, 1][:, None, None]))
    if feature_masks is not None:
        fm = np.zeros((B, h, w), bool)
        for i, m in enumerate(feature_masks[stack.lo:stack.lo + B]):
            if m is None:
                fm[i] = True
            else:
                mh, mw = m.shape[:2]
                fm[i, :mh, :mw] = np.asarray(m) > 0
        region = region & torch.as_tensor(fm, device=dev)
    return DETECTORS[variant](gray, region, nfeatures=nfeatures)


# ---------------------------------------------------------------------------
# Batched pair matching + RANSAC
# ---------------------------------------------------------------------------

def make_pairs(n, range_width=-1):
    """Host pair list (i < j), optionally banded by |i-j| <= range_width."""
    out = [(i, j) for i in range(n) for j in range(i + 1, n)
           if range_width == -1 or j - i <= range_width]
    return np.asarray(out, np.int32).reshape(-1, 2)


def _match_pairs(desc, valid, xy, centers, pair_ij, seeds, match_conf, *,
                 is_binary, model):
    """All pairs of one chunk at once.

    desc: (B, N, D); valid: (B, N); xy: (B, N, 2); centers: (B, 2);
    pair_ij: (P, 2) int32; seeds: (P,) uint32 seeds (int64 tensor);
    model: "homography" or "affine" (the 4-DoF similarity).
    """
    d0, d1, i0 = two_nn_pairs(desc, valid, pair_ij, is_binary=is_binary)
    if not is_binary:
        d0 = torch.sqrt(d0)
        d1 = torch.sqrt(d1)
    pi = pair_ij[:, 0].long()
    pj = pair_ij[:, 1].long()
    pairs, mvalid = ratio_union(d0[:, 0], d1[:, 0], i0[:, 0],
                                d0[:, 1], d1[:, 1], i0[:, 1],
                                valid[pi], valid[pj], match_conf)

    def pts(img_idx, col):
        g = torch.gather(xy[img_idx], 1,
                         pairs[..., col, None].expand(-1, -1, 2))
        return g - centers[img_idx][:, None, :]

    ransac = ransac_affine_partial if model == "affine" else \
        ransac_homography
    r = ransac(pts(pi, 0), pts(pj, 1), mvalid, seeds)
    nm = mvalid.sum(-1)
    ni = torch.where(r["ok"], r["num_inliers"], 0)
    conf = ni.to(torch.float32) / fma(nm.to(torch.float32), 0.3, 8.0)
    conf = torch.where((conf > 3.0) | (nm < 6) | ~r["ok"], 0.0, conf)
    return dict(pairs=pairs.to(torch.int32), matches_valid=mvalid,
                H=r["H"], inliers=r["inliers"] & (conf > 0)[:, None],
                num_inliers=torch.where(conf > 0, ni, 0),
                num_matches=nm, confidence=conf,
                ok=r["ok"] & (conf > 0))


def match_stack_dispatch(feats, img_sizes, *, matcher_type="homography",
                         match_conf=0.3, range_width=-1, is_binary=True,
                         n_images=None, mesh=None):
    """Launch the batched pair matcher without copying results to host.

    Returns (pair_list, [(device_out, n_valid), ...]) — one entry per pair
    chunk; `match_stack_fetch` copies them to host.

    With a mesh (every rank holding every image's features), each chunk's
    pair axis pads to a multiple of the rank count (padded pairs are
    (0, 0) with seed 0), each rank matches its block through the 2-NN
    kernel, and the fixed-shape results are gathered, so every rank holds
    them all. The per-pair seeds i * n + j make the RANSAC draws
    independent of the split.
    """
    desc = feats["desc"]
    dev = desc.device
    n = n_images if n_images is not None else desc.shape[0]
    pair_ij = make_pairs(n, range_width)
    prof.count("match/pairs", len(pair_ij))
    if len(pair_ij) == 0:
        return pair_ij, None
    seeds = (pair_ij[:, 0].astype(np.uint32) * np.uint32(n)
             + pair_ij[:, 1].astype(np.uint32))
    b = desc.shape[0]
    # the homography model centres coordinates on the image centre (the
    # cv.detail convention); the affine model takes raw pixels
    centers = np.zeros((b, 2), np.float32)
    if matcher_type != "affine":
        centers[:len(img_sizes)] = np.asarray(img_sizes, np.float32) * 0.5
    centers = torch.as_tensor(centers, device=dev)
    valid = torch.as_tensor(feats["valid"], device=dev)
    xy = torch.as_tensor(feats["xy"], device=dev)

    # chunk the pair axis: the batched program holds O(P * N * N) distance
    # state, which at the 100+-image scale (P ~ 5000) would not fit memory
    nn = desc.shape[1]
    chunk_cap = max(64, int(2_000_000_000 // max(4 * nn * nn, 1)))
    chunks = []
    total = len(pair_ij)
    for lo in range(0, total, chunk_cap):
        hi = min(lo + chunk_cap, total)
        seed_c = seeds[lo:hi].astype(np.int64)
        if mesh is None:
            pair_t = torch.as_tensor(pair_ij[lo:hi], device=dev)
            seed_t = torch.as_tensor(seed_c, device=dev)
        else:
            pair_t = shard_leading(pair_ij[lo:hi], mesh)
            seed_t = shard_leading(seed_c, mesh)
        out = _match_pairs(desc, valid, xy, centers, pair_t, seed_t,
                           float(match_conf), is_binary=is_binary,
                           model=("affine" if matcher_type == "affine"
                                  else "homography"))
        if mesh is not None:
            out = {k: all_gather_leading(v, mesh) for k, v in out.items()}
        chunks.append((out, hi - lo))
    return pair_ij, chunks


def match_stack_fetch(chunks):
    """Copy dispatched match chunks to host -> dict of numpy arrays."""
    host = [{k: v.cpu().numpy()[:nv] for k, v in out.items()}
            for out, nv in chunks]
    return {k: np.concatenate([c[k] for c in host]) for k in host[0]}


def match_stack(feats, img_sizes, **kwargs):
    """Match every image pair; results copied to host.

    Returns (pair_list, results) where results is a dict of numpy arrays
    with leading pair axis (None when there is no pair).
    """
    pair_ij, chunks = match_stack_dispatch(feats, img_sizes, **kwargs)
    if chunks is None:
        return pair_ij, None
    return pair_ij, match_stack_fetch(chunks)


# ---------------------------------------------------------------------------
# One pair of frames
# ---------------------------------------------------------------------------

def register_pair(img_a, img_b, *, nfeatures=256, n_iters=N_HYPOTHESES,
                  device="cuda"):
    """Register two frames: ORB detection, `match_pair` (the per-pair 2-NN
    kernel in both directions, ratio confidence 0.3) and the RANSAC
    homography (seed 0, `n_iters` hypotheses), in uncentered pixel
    coordinates. Counterpart of the reference's per-pair entry (detect_orb
    -> match_pair -> ransac_homography; the entry draws 128 hypotheses).

    img_a, img_b: (H, W) gray or (H, W, 3) BGR arrays in [0, 255]. Returns
    (H (3, 3) float32 tensor mapping a's pixels to b's, num_inliers int
    tensor), both on `device`.
    """
    with no_tf32():
        return _register_pair(img_a, img_b, nfeatures, n_iters, device)


def _register_pair(img_a, img_b, nfeatures, n_iters, device):
    feats = []
    for img in (img_a, img_b):
        plane = torch.as_tensor(np.array(img, np.float32), device=device)
        if plane.dim() == 3:
            plane = bgr_to_gray(plane)
        feats.append({k: v[0] for k, v in detect_orb(
            plane[None], nfeatures=nfeatures).items()})
    fa, fb = feats
    m = match_pair(fa["desc"], fa["valid"], fb["desc"], fb["valid"],
                   0.3, is_binary=True)
    pairs = m["pairs"].long()
    src = fa["xy"][pairs[:, 0]]
    dst = fb["xy"][pairs[:, 1]]
    seeds = torch.zeros(1, dtype=torch.int64, device=src.device)
    r = ransac_homography(src[None], dst[None], m["valid"][None], seeds,
                          n_iters=n_iters)
    return r["H"][0], r["num_inliers"][0]
