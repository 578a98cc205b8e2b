"""Import real openSMILE functionals into the feature store.

Counterpart of ``sept_tpu/data/opensmile_import.py`` (it imports nothing of
the JAX package, and the port keeps its own copy).  The reference's 88-dim
``global_data`` is openSMILE eGeMAPSv02 Functionals output and its
``emobase`` the 988-dim emobase functional set; the port computes stand-ins
of the same widths (``ops/egemaps.py``, ``ops/emobase.py``) that are not
value-interoperable with reference artifacts.  A user who has openSMILE
output injects the actual values into the store, verbatim, and every later
stage (the per-speaker z-norm of the 88-dim globals, ``--global_feature``,
the artifact exchange) then runs on the reference pipeline's numbers.

Two input formats:

- **CSV** as written by ``opensmile``'s pandas output
  (``smile.process_file(...)`` frames concatenated and ``.to_csv()``-ed): a
  ``file`` column (the wav path; its basename without extension is the
  utterance id), optional ``start`` / ``end`` columns, then the features;
- **the reference's feature pickle** (``feature/<type>/<dataset>/
  data_<len>.pkl``): ``{utt_id: {'gemaps': DataFrame, 'emobase':
  DataFrame, ...}}``; the gemaps / emobase entries are lifted out, the rest
  ignored.  The port imports no pandas: unpickling DataFrames needs it, and
  its ``ImportError`` surfaces as it is.

The feature set is inferred from the width, 88 -> ``gemaps``, 988 ->
``emobase``; any other width is refused.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["load_opensmile_file", "apply_opensmile"]

_WIDTH_TO_NAME = {88: "gemaps", 988: "emobase"}
_META_COLS = ("file", "start", "end")


def _utt_id_of(file_field: str) -> str:
    """openSMILE indexes rows by wav path; utterance ids everywhere in this
    framework are the basename without extension (data/walkers.py)."""
    base = os.path.basename(str(file_field))
    stem, _ = os.path.splitext(base)
    return stem or str(file_field)


def _classify(vec: np.ndarray, source: str) -> str:
    name = _WIDTH_TO_NAME.get(vec.shape[-1])
    if name is None:
        raise ValueError(
            f"{source}: functional vector has {vec.shape[-1]} values; "
            "expected 88 (eGeMAPSv02 Functionals) or 988 (emobase "
            "functionals)"
        )
    return name


def _load_csv(path: str) -> dict[str, dict[str, np.ndarray]]:
    import csv

    out: dict[str, dict[str, np.ndarray]] = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError(f"{path}: empty CSV")
        feat_cols = [c for c in reader.fieldnames if c not in _META_COLS]
        if "file" not in reader.fieldnames:
            raise ValueError(
                f"{path}: no 'file' column — expected openSMILE pandas "
                "output (file[,start,end],<features...>)"
            )
        for row in reader:
            vec = np.asarray([float(row[c]) for c in feat_cols],
                             dtype=np.float32)
            name = _classify(vec, path)
            out.setdefault(_utt_id_of(row["file"]), {})[name] = vec
    return out


def _load_pickle(path: str) -> dict[str, dict[str, np.ndarray]]:
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if not isinstance(blob, dict):
        raise ValueError(f"{path}: expected a dict feature store pickle")
    out: dict[str, dict[str, np.ndarray]] = {}
    for utt, feats in blob.items():
        if not isinstance(feats, dict):
            continue
        for key in ("gemaps", "emobase"):
            if key in feats:
                vec = np.asarray(feats[key], dtype=np.float32).ravel()
                # trust the reference's own key over width inference, but
                # still refuse wrong-width vectors
                want = {v: k for k, v in _WIDTH_TO_NAME.items()}[key]
                if vec.shape[-1] != want:
                    raise ValueError(
                        f"{path}: {utt!r}[{key}] has {vec.shape[-1]} values,"
                        f" expected {want}"
                    )
                out.setdefault(str(utt), {})[key] = vec
    return out


def load_opensmile_file(path: str) -> dict[str, dict[str, np.ndarray]]:
    """-> {utt_id: {'gemaps': (88,) and/or 'emobase': (988,)}}."""
    if path.endswith((".pkl", ".pickle", ".pk")):
        return _load_pickle(path)
    return _load_csv(path)


def apply_opensmile(
    store: dict[str, dict[str, np.ndarray]],
    imported: dict[str, dict[str, np.ndarray]],
) -> tuple[int, list[str], dict[str, list[str]]]:
    """Overwrite the store's stand-in functionals with imported values.

    Returns ``(n_replaced, unmatched_ids, uncovered)``:

    - ``n_replaced`` counts (utterance, feature-set) pairs written;
    - ``unmatched_ids`` lists imported utterance ids absent from the store
      (a typo'd CSV fails loudly at the CLI instead of silently training
      on stand-ins);
    - ``uncovered`` maps each imported feature-set name to the STORE
      utterances the import did NOT cover — a partial CSV would otherwise
      silently mix real openSMILE values with computed stand-ins (or the
      zeros of fold assembly) and defeat the interoperability guarantee."""
    replaced, unmatched = 0, []
    names = {n for feats in imported.values() for n in feats}
    for utt, feats in imported.items():
        if utt not in store:
            unmatched.append(utt)
            continue
        for name, vec in feats.items():
            store[utt][name] = vec
            replaced += 1
    uncovered = {
        name: [u for u in store if name not in imported.get(u, ())]
        for name in sorted(names)
    }
    return replaced, unmatched, {k: v for k, v in uncovered.items() if v}
