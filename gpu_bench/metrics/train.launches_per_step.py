"""Device operations (kernels, copies, sets) a training step, over the
traced slice's steps."""


def read(rec, cell):
    t = rec.trace
    if cell.traffic["kind"] != "train" or t is None or t.busy_s <= 0 or not rec.slice_steps:
        return None
    return t.device_ops / rec.slice_steps
