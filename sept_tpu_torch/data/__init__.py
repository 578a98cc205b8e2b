"""Host data of the port (corpora, walkers, folds, windowing, normalization,
augmentation, stores, the synthetic corpus), data staging, on-device ingest
and corpus featurization."""
