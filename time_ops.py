#!/usr/bin/env python3
"""Host cost of calling a kernel through its custom op.

Run on a machine with an NVIDIA GPU:

    python3 time_ops.py [--calls N]

Each kernel is launched N times in a row, on the same inputs, three ways:
its ctypes launch function called directly (``softargmax_kernel._launch``,
the CUDA implementations of ``int8_gemm_kernel``), the custom op
(``softargmax_kernel.OP``, ``MM_OP``, ``CONV_OP``), and the Python wrapper
the model calls (``softargmax_likelihood``, ``conv_int8``). The host
microseconds a call are the wall time of the N calls, from the first issue
to the synchronize after the last, over N; the shapes are small, so the
card finishes each launch before the host issues the next and the time is
the host's. The ways run in turns (direct, op, wrapper, wrapper, op,
direct) and each is reported with both of its runs. Prints one JSON line:
the card's name and power limit and, per kernel, the microseconds of each
way.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def per_call_us(fn, calls: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=2000)
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("time_ops.py: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    maps = torch.randn((1, 94, 104, 5), generator=gen, device=dev)
    # a 1x1 stride-1 site (mm_tiled) and a 3x3 one (conv_int8) of
    # ResNet-50's block 1, one frame at a quarter of 747x832's grid
    x = torch.randint(-127, 128, (1, 47, 52, 64), generator=gen,
                      device=dev, dtype=torch.int8)
    w1 = torch.randint(-127, 128, (64, 256), generator=gen, device=dev,
                       dtype=torch.int8)
    w3 = torch.randint(-127, 128, (9 * 64, 64), generator=gen, device=dev,
                       dtype=torch.int8)
    w1_nk, w3_nk = w1.t().contiguous(), w3.t().contiguous()
    oscale = torch.full((256,), 1e-3, device=dev)
    bias = torch.zeros(256, device=dev)
    a1 = x.view(-1, 64)
    ways = {
        "softargmax_likelihood": {
            "direct": lambda: sk._launch(maps, 1.0, 2.0, 1.0),
            "op": lambda: sk.OP(maps, 1.0, 2.0, 1.0),
            "wrapper": lambda: sk.softargmax_likelihood(maps, 1.0, 2.0)},
        "mm_tiled": {
            "direct": lambda: gk._mm_cuda(a1, w1_nk, oscale, bias, 1,
                                          gk.OUT_BF16, 0.0, None),
            "op": lambda: gk.MM_OP(a1, w1_nk, oscale, bias, 1, gk.OUT_BF16,
                                   0.0, None),
            "wrapper": lambda: gk.conv_int8(x, w1, 1, 1, 1, 0, oscale, bias,
                                            1, torch.bfloat16,
                                            w_nk=w1_nk)},
        "conv_int8": {
            "direct": lambda: gk._conv_cuda(x, w3_nk, oscale[:64],
                                            bias[:64], 3, 1, 1, 1, 1, 1, 1,
                                            1, gk.OUT_BF16, 0.0),
            "op": lambda: gk.CONV_OP(x, w3_nk, oscale[:64], bias[:64], 3, 1,
                                     1, 1, 1, 1, 1, 1, gk.OUT_BF16, 0.0),
            "wrapper": lambda: gk.conv_int8(x, w3, 3, 1, 1, 1, oscale[:64],
                                            bias[:64], 1, torch.bfloat16,
                                            w_nk=w3_nk)},
    }
    out = {"card": smoke.card_line(), "calls": args.calls, "us_per_call": {}}
    for name, fns in ways.items():
        runs = {k: [] for k in fns}
        for way in ("direct", "op", "wrapper", "wrapper", "op", "direct"):
            runs[way].append(per_call_us(fns[way], args.calls))
        out["us_per_call"][name] = runs
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
