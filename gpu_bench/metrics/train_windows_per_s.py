"""Training windows completed over the window's whole wall time, the
validation passes inside it."""


def read(rec, cell):
    if cell.traffic["kind"] != "train" or rec.window_s <= 0:
        return None
    return rec.windows_done / rec.window_s
