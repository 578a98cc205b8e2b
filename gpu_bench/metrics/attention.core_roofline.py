"""The attention core against its roofline in the traced run's span
steps, %: the least time of a training step's attention-core work (the
family module's ``attention_core_least_s``: each forward call's 4 B H T^2
hd FLOPs and each backward call's 8 B H T^2 hd at the bf16 peak, or their
q, k, v and output bytes where those take longer) over the device time a
step launched under the program's ``attention.core`` spans, forward and
backward.  Nothing where the program opens no such span or the family
counts no attention core."""

from gpu_bench.harness.cell import family
from gpu_bench.harness.spans import device_ms_per_step


def read(rec, cell):
    ms = device_ms_per_step(rec.spans, "attention.core")
    least = getattr(family(cell.config), "attention_core_least_s", None)
    if ms is None or least is None:
        return None
    return 100.0 * least(cell.config, cell.traffic["batch_size"]) / (1e-3 * ms)
