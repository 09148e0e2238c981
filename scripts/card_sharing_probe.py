"""How one card shares between processes: per-launch time of a tiny
kernel (an in-place add on 1,000 floats) in 1, 2 and 4 processes at once,
with a host sync after every 1, 30 or 300 launches.

    python3 scripts/card_sharing_probe.py      # on a CUDA card, ~100 s

Without MPS the card time-slices between the processes' contexts, so what
a process pays grows with how often it syncs: the sharded solves on one
card (``parallel/sharded_solve.py``) sync once per all-reduce.
"""
import multiprocessing as mp
import time

import torch


def work(rank, n, burst, total, q, start):
    torch.cuda.set_device(0)
    x = torch.zeros(1000, device="cuda")
    for _ in range(200):
        x.add_(1.0)
    torch.cuda.synchronize()
    start.wait()
    t = time.time()
    for i in range(total):
        x.add_(1.0)
        if (i + 1) % burst == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    q.put((time.time() - t) / total * 1e6)


if __name__ == "__main__":
    ctx = mp.get_context("spawn")
    for n in (1, 2, 4):
        for burst in (1, 30, 300):
            q, start = ctx.Queue(), ctx.Event()
            ps = [ctx.Process(target=work, args=(r, n, burst, 6000, q, start))
                  for r in range(n)]
            for p in ps:
                p.start()
            time.sleep(6 if n > 1 else 4)
            start.set()
            us = [q.get(timeout=300) for _ in ps]
            for p in ps:
                p.join()
            print(f"processes {n} sync every {burst}: us per launch "
                  f"{[round(u, 1) for u in us]}", flush=True)
