"""The input generator: stack pairs made on the device from ``--seed``.

A traffic file's ``inputs`` describe a projected-pattern stereo rig: every
shot projects a uniformly random pattern (``(n, H, W + max_disp)``
samples over the configuration's depth), the right camera sees columns
``[max_disp, max_disp + W)`` and the left camera sees them shifted by a
smooth integer disparity field on left pixel coordinates,

    d(y, x) = 1 + floor(f * (max_disp - 1)),
    f = (sin(rows_pi * pi * y / (H - 1)) cos(cols_pi * pi * x / (W - 1)) + 1) / 2,

so that ``left[x]`` sees what ``right[x - d]`` sees (true disparities 1
.. max_disp, with ``max_disp = W // max_disp_divisor``). That is the model
of the reference bench's synthetic stacks. Each camera then adds its own
sensor noise, uniform integers in ``[-noise, noise]``, clamped to the
depth's range: without it every true match is exact (NXCORR 1 at x = 0),
and every pair of one field gives the same maps. The pool holds
``pool_pairs`` distinct pairs, drawn one after another from one generator
on the device; the field is the same for every seed, so every seed gives
the same amount of work.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16}


def disparity_field(h: int, w: int, inputs: dict, device) -> torch.Tensor:
    """The ``(H, W)`` int32 true disparity of the traffic's inputs."""
    max_disp = max(4, w // int(inputs["max_disp_divisor"]))
    y = torch.linspace(0, inputs["rows_pi"] * math.pi, h,
                       dtype=torch.float64, device=device)[:, None]
    x = torch.linspace(0, inputs["cols_pi"] * math.pi, w,
                       dtype=torch.float64, device=device)[None, :]
    f = (torch.sin(y) * torch.cos(x) + 1) / 2
    return (1 + f * (max_disp - 1)).to(torch.int32)


def make_pool(cfg: dict, traffic: dict, seed: int, device, shape=None):
    """``traffic["pool_pairs"]`` distinct ``(left, right)`` pairs of
    ``(n, H, W)`` stacks on ``device``; ``shape`` overrides the
    configuration's ``(n, H, W)`` (the CPU tests use a tiny one)."""
    n, h, w = shape or (cfg["n"], cfg["height"], cfg["width"])
    dtype = DTYPES[cfg["dtype"]]
    inputs = traffic["inputs"]
    if inputs.get("model") != "warped_random_pattern":
        raise ValueError(f"unknown input model {inputs.get('model')!r}")
    disp = disparity_field(h, w, inputs, device)
    max_disp = max(4, w // int(inputs["max_disp_divisor"]))
    src = (torch.arange(w, dtype=torch.int64, device=device)[None]
           + max_disp - disp.to(torch.int64))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    hi = torch.iinfo(dtype).max
    noise = int(inputs.get("noise", 0))

    def sensor(view):
        if not noise:
            return view.contiguous()
        e = torch.randint(-noise, noise + 1, view.shape, generator=gen,
                          dtype=torch.int32, device=device)
        return (view.to(torch.int32) + e).clamp_(0, hi).to(dtype)

    pool = []
    for _ in range(int(traffic["pool_pairs"])):
        pattern = torch.randint(0, hi + 1, (n, h, w + max_disp),
                                generator=gen, dtype=dtype, device=device)
        seen = torch.empty((n, h, w), dtype=dtype, device=device)
        for t in range(n):
            seen[t] = torch.gather(pattern[t], 1, src)
        left = sensor(seen)
        right = sensor(pattern[:, :, max_disp:max_disp + w])
        del pattern, seen
        pool.append((left, right))
    return pool
