"""Bilinear sampler with the contract of the TPU block samplers.

Port of `stitching_tpu/ops/pallas/block_warp.py::block_sample_dma` (and
`block_sample`, which has the same contract for narrow sources):
bilinear samples of an edge-padded (B, H, W, C) float32 stack at per-pixel
source coordinates (B, th, tw), giving (B, th, tw, C), exact at `care`
pixels. Both taps of an axis clamp to the padded extent.

`bilinear_sample` launches the CUDA kernel (`csrc/bilinear_sample.cu`) for
tensors on the card and runs `bilinear_sample_plain` for tensors on the
CPU. Both compute every pixel exactly; `care` is part of the contract
because the TPU version is exact only there.
"""

import torch

from . import check, load, stream_ptr


def bilinear_sample_plain(data, sxc, syc, care=None):
    """Four gathers and the lerp
    `((1-fx)a + fx b)(1-fy) + ((1-fx)c + fx d)fy`."""
    B, H, W, C = data.shape
    th, tw = sxc.shape[1], sxc.shape[2]
    x0f = torch.floor(sxc)
    y0f = torch.floor(syc)
    fx = (sxc - x0f)[..., None]
    fy = (syc - y0f)[..., None]
    x0 = x0f.long().clamp(0, W - 1)
    y0 = y0f.long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)
    flat = data.reshape(B, H * W, C)

    def tap(yy, xx):
        idx = (yy * W + xx).reshape(B, th * tw, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, th, tw, C)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
    bot = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def bilinear_sample(data, sxc, syc, care):
    """Bilinear samples (B, th, tw, C); the CUDA kernel on the card, the
    plain version on the CPU."""
    if data.device.type == "cpu":
        return bilinear_sample_plain(data, sxc, syc, care)
    B, H, W, C = data.shape
    if sxc.dim() != 3 or sxc.shape[0] != B:
        raise ValueError("bilinear_sample: sxc must be (B, th, tw)")
    th, tw = sxc.shape[1], sxc.shape[2]
    for name, t, dt in (("data", data, torch.float32),
                        ("sxc", sxc, torch.float32),
                        ("syc", syc, torch.float32),
                        ("care", care, torch.bool)):
        if t.dtype != dt or t.device != data.device:
            raise ValueError(f"bilinear_sample: {name} must be {dt} on "
                             f"{data.device}")
        if name != "data" and t.shape != (B, th, tw):
            raise ValueError(f"bilinear_sample: {name} must be (B, th, tw)")
    data = data.contiguous()
    sxc = sxc.contiguous()
    syc = syc.contiguous()
    out = torch.empty((B, th, tw, C), dtype=torch.float32,
                      device=data.device)
    fn = load("bilinear_sample")
    with torch.cuda.device(data.device):
        status = fn(data.data_ptr(), sxc.data_ptr(), syc.data_ptr(),
                    out.data_ptr(), B, H, W, C, th, tw,
                    stream_ptr(data.device))
    check(status, "bilinear_sample")
    bilinear_sample.launches += 1
    return out


bilinear_sample.launches = 0
