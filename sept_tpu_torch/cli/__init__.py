"""Command lines of the port: featurize, preprocess, train_baseline,
train_cloak, evaluate and run_all (``python -m sept_tpu_torch.cli.<name>``)."""
