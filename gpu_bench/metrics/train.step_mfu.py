"""The whole step's share of the chip's peak, %: the model family's FLOPs a
training window (``train_flops_per_window`` of ``reference/<family>.py``)
times the windows a second of the traced run's window, which closes before
the profiler starts, over the peak of the cell's compute dtype
(harness/counts.py)."""

from gpu_bench.harness import counts
from gpu_bench.harness.cell import family


def read(rec, cell):
    t = rec.trace
    if cell.traffic["kind"] != "train" or t is None or t.busy_s <= 0 or rec.window_s <= 0:
        return None
    rate = rec.windows_done / rec.window_s
    peak = counts.PEAKS[cell.traffic["compute_dtype"]]
    return 100.0 * family(cell.config).train_flops_per_window(cell.config) * rate / peak
