"""Share of the traced training slice in which no device operation ran, %."""


def read(rec, cell):
    t = rec.trace
    if cell.traffic["kind"] != "train" or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
