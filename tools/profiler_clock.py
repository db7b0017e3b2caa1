"""How many of a session's kernels torch.profiler keeps as the process ages.

Every `--every` seconds, for `--seconds` in all, three profiler sessions, each
launching 20 small kernels: one plain, one that first waits `--wait` seconds
on the host, one that first launches `--lead` other tiny kernels.  Between
probes the card runs matmuls.  One JSON line a session: the process's age,
the variant, and how many of the 20 the profiler saw.  chip_smoke.py's
profiler sessions start with PROFILE_LEAD_KERNELS tiny kernels for what this
shows.

    python3 tools/profiler_clock.py [--seconds 240] [--every 30] [--wait 0.2] [--lead 512]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

LAUNCHES = 20


def session(y: torch.Tensor, wait_s: float, lead: int) -> int:
    """Kernels the profiler saw of LAUNCHES `add_` kernels launched in one
    session, after a host wait of `wait_s` and `lead` `mul_` kernels."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(wait_s)
        for _ in range(lead):
            y.mul_(1.0)
        for _ in range(LAUNCHES):
            y.add_(1.0)
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA and "add" in e.name.lower()
               for e in prof.events())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--every", type=float, default=30.0)
    ap.add_argument("--wait", type=float, default=0.2)
    ap.add_argument("--lead", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_clock: needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    x = torch.randn(4096, 4096, device=dev)
    y = torch.zeros(256, device=dev)
    t0, due = time.perf_counter(), 0.0
    while True:
        age = time.perf_counter() - t0
        if age >= due:
            for wait_s, lead in ((0.0, 0), (args.wait, 0), (0.0, args.lead)):
                print(json.dumps(dict(age_s=age, wait_s=wait_s, lead=lead, launched=LAUNCHES,
                                      seen=session(y, wait_s, lead))), flush=True)
            due += args.every
        if age >= args.seconds:
            break
        for _ in range(50):
            x @ x
        torch.cuda.synchronize()


if __name__ == "__main__":
    main()
