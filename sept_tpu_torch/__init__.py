"""PyTorch / CUDA port of sept_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference ``sept_tpu``: it imports torch
and numpy and nothing of JAX or of ``sept_tpu``.  Ported so far: the serving
path (mel frontend, Conv2dBiRNN eval forward, the cloak noise layer, the HTTP
server), the training path (ingest, baseline, cloak and cloak + GRL epochs),
corpus featurization (mel_spec and MFCC stores, the bf16 ingest), and one
fold of the utility-privacy protocol: the fold drivers (best by validation,
early stopping, plateau, mid-fold resume, the sliding-window test vote), the
checkpoints that link the stages, the baseline's and the cloak's
``run_fold`` and the suppression sweep; and the protocol through its
command lines: the host data (corpora, walkers, speaker-disjoint folds,
windowing, normalization, augmentation, stores), the native WAV decoder and
the featurize, preprocess, train_baseline, train_cloak, evaluate and
run_all CLIs (``python -m sept_tpu_torch.cli.<name>``); artifacts in and
out: ``serve.load_predictor``, the serve and predict CLIs, and the
export_torch / import_torch CLIs to and from the reference's ``model.pt``;
every model type of the JAX package (the deep CNN + RNN, GRU or LSTM,
the 1-D CNN, the plain 2-D CNN); and the global feature: the 88-dim gemaps
and 988-dim emobase functionals (``ops/egemaps.py``, ``ops/emobase.py``),
the openSMILE import, and ``--global_feature 1`` from featurize to the
sweep; and data parallelism (``sept_tpu_torch.parallel``: process groups,
sync-BN through block 1's kernels, the DP step and epoch runners, and
``--n_devices`` / ``SEPT_*`` through the fold drivers, the sweep and the
CLIs); and the last modules: the host fold loop (``train.fit``,
``run_train_epoch``, ``run_eval_epoch``, a profiled first epoch with
``profile_dir``), ``utils`` (``trace``, ``StepTimer``, ``KeySeq``,
``fold_in_name``), one utterance's functionals and ``runtime.have_native``.
Each subpackage exports the counterpart of every name in the JAX
subpackage's ``__all__`` (``from sept_tpu_torch.train import fit,
ExperimentConfig``); the few JAX names with no module-level counterpart
are mapped in the README.  The mel chain (f32 and bf16), the MFCC's floor +
DCT and the first conv block are hand-written CUDA kernels
(``sept_tpu_torch/csrc``).  What only a benchmark or more cards can show is
listed in ROADMAP.md.
"""
