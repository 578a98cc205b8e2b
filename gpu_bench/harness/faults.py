"""Faults planted under the timed path, for the checks that ``correct``
catches them (the tests on the CPU, ``calibrate.py`` on the card).  Each
takes what the training driver built and breaks it in place."""


def state_unchanged(job):
    """Every step returns the state as it was: no update."""
    job.state.optimizer.step = lambda: None


def half_batch(job):
    """Every other row of the training split leaves the loss: each batch's
    mean is taken over the rest."""
    job.weights[::2] = 0.0


TRAINING = {"state_unchanged": state_unchanged, "half_batch": half_batch}
