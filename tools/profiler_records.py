"""How many kernel records does torch.profiler lose at the head of a
window, and does a head of short sleep kernels absorb the loss?

Run on a CUDA card: python3 tools/profiler_records.py

Each of 8 rounds does some work outside any profiler (3,000 small
kernels, one profiled window of 200 launches) and then profiles short
windows of one call of `(a == b).all(-1)` on 2^20 x 8 words (2 kernels)
or of 20 calls (40 kernels), bare and behind HEAD sleep kernels, and
prints the measured kernels' records kept (and the sleep kernels'),
then sleeps 10 s.  chip_smoke.py's device_ms opens each window with
such a head for this reason.
"""

import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

HEAD = 256


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", smi, "| torch", torch.__version__, flush=True)
    a = torch.randint(0, 1 << 30, (1 << 20, 8), dtype=torch.int32,
                      device="cuda")
    b = a.clone()
    b[::3] += 1
    cuda = torch.autograd.DeviceType.CUDA

    def window(iters, head):
        """(measured kernel records kept of 2 * iters, head records kept)."""
        (a == b).all(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(head):
                torch.cuda._sleep(1)
            for _ in range(iters):
                (a == b).all(-1)
            torch.cuda.synchronize()
        ev = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
        nh = sum("spin" in e.name() for e in ev)
        return len(ev) - nh, nh

    t0 = time.time()
    for _ in range(8):
        x = a
        for _ in range(3000):
            x = x * 3 + 1
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(200):
                torch.neg(a)
            torch.cuda.synchronize()
        print("at %3.0f s: 1 call (2 kernels) bare %s, behind %d sleeps %s;"
              " 20 calls (40 kernels) bare %s, behind the sleeps %s" % (
                  time.time() - t0,
                  [window(1, 0)[0] for _ in range(4)], HEAD,
                  [window(1, HEAD) for _ in range(4)],
                  [window(20, 0)[0] for _ in range(2)],
                  [window(20, HEAD) for _ in range(2)]), flush=True)
        time.sleep(10)


if __name__ == "__main__":
    main()
