"""Command lines of the port: featurize, preprocess, train_baseline,
train_cloak, evaluate, run_all, serve, predict, export_torch and import_torch
(``python -m sept_tpu_torch.cli.<name>``)."""
