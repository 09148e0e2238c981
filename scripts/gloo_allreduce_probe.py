"""All-reduce cost on one card: gloo on CUDA tensors against gloo on
pinned host tensors with explicit copies, in pairs of ranks (2 or 4 ranks
at once) at the sharded mu sweep's buffer (106,496 x 10 f64, 8.5 MB) and
a fifth of it; milliseconds per all-reduce over 30 after 3 warm-ups.

    python3 scripts/gloo_allreduce_probe.py    # on a CUDA card, ~60 s
"""
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def work(rank, n, path, nbytes, reps, q):
    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(path, n), rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    groups = ([dist.new_group([0, 1]), dist.new_group([2, 3])] if n == 4
              else [dist.new_group([0, 1])])
    g = groups[rank // 2]
    x = torch.randn(nbytes // 8, dtype=torch.float64, device="cuda")
    h = torch.empty(x.shape, dtype=torch.float64, pin_memory=True)
    out = {}
    for tag in ("cuda", "staged"):
        for i in range(reps + 3):
            if i == 3:
                torch.cuda.synchronize()
                dist.barrier()
                t = time.time()
            if tag == "cuda":
                dist.all_reduce(x, group=g)
            else:
                h.copy_(x, non_blocking=True)
                torch.cuda.current_stream().synchronize()
                dist.all_reduce(h, group=g)
                x.copy_(h, non_blocking=True)
        torch.cuda.synchronize()
        out[tag] = (time.time() - t) / reps * 1e3
    if rank == 0:
        q.put(out)
    dist.destroy_process_group()


if __name__ == "__main__":
    ctx = mp.get_context("spawn")
    for n in (2, 4):
        for nbytes in (8_519_680, 1_703_936):
            q = ctx.Queue()
            d = tempfile.mkdtemp()
            ps = [ctx.Process(target=work, args=(
                r, n, os.path.join(d, "s"), nbytes, 30, q))
                for r in range(n)]
            for p in ps:
                p.start()
            print(f"ranks {n} bytes {nbytes}: ms per all-reduce "
                  f"{q.get(timeout=300)}", flush=True)
            for p in ps:
                p.join()
