"""Block 1's kernels (K1-K5, csrc/conv_block1.cu) against their roofline
in the traced training slice, %: the sum of each launch's least time (its
shape's bytes and operations, harness/counts.py) over the profiler's device
time of every kernel of that source."""

import re

from gpu_bench.harness import counts

KERNELS = re.compile(r"\b(conv_stats|reduce_partials|norm_pool|route|weight_grads|input_grad)"
                     r"(_mma)?_kernel\b")


def read(rec, cell):
    t = rec.trace
    if cell.traffic["kind"] != "train" or t is None or t.busy_s <= 0:
        return None
    device_s = t.time_matching(lambda n: KERNELS.search(n) is not None)
    cfg, bs = cell.config, cell.traffic["batch_size"]
    least = sum(n * counts.block1_bound(k, bs, cfg["channels"][0], cfg["win_len"],
                                        cfg["feature_len"], mode)
                for (k, mode), n in rec.launches.items())
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
